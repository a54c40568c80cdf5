"""The editor's views (counterpart of ``lumixengine_tpu/editor/``): the
asset compiler with its file watcher, and the views that drive the device:
the game view (play in editor through the Runner), the animation graph
editor, the particle script editor and the voxelizer. Terminal-grade: each
view renders to text with ANSI half-block images (``core/os_terminal.py``).
The host-only views and the editor app are not ported yet (ROADMAP Queue 1
item 7.6)."""
