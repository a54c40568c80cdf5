"""hulls.sdf_ms: device time a frame of the span physics.sdf_streams: every
polytope vertex sampled in each SDF mesh collider's grid, with its
gradient (physics/module.py _sdf_streams), inside physics.contacts
(harness/spans.py). None where the program has no such span."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, "physics.sdf_streams")
