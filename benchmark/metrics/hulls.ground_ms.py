"""hulls.ground_ms: device time a frame of the span physics.hull_ground: the
hulls' vertices against the ground plane (ops/convex_ops.py
polytope_ground_grids) in the banded branch's per-body stream, inside
physics.contacts (harness/spans.py). None where the program has no such
span."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, "physics.hull_ground")
