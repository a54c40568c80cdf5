"""hierarchy.in_frame_ms: device time a frame of the transform propagation
inside the frame step (the span hierarchy.propagate around
ops/hierarchy.py::propagate_plan; harness/spans.py)."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, "hierarchy.propagate")
