"""cull.in_frame_ms: device time a frame of the cull pass inside the frame
step (the span renderer.cull_pass around the step's extra pass, kernel K1
among it; harness/spans.py)."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, "renderer.cull_pass")
