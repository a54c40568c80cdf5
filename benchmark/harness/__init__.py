"""The benchmark's harness: it finds a cell's files by name, builds the
scene through the port, times the window, reads the per-layer metrics and
holds what the window produced to the plain reference."""
