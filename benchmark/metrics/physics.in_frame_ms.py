"""physics.in_frame_ms: device time a frame of the physics module's phases
inside the frame step (the physics.<phase> spans: update_parallel, with
the contact stage and kernel K2, and update; harness/spans.py)."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, *spans.phase_spans("physics"))
