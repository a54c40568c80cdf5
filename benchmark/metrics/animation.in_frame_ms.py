"""animation.in_frame_ms: device time a frame of the animation module's
phases inside the frame step (the spans animation.update_parallel and
animation.update, their launches' device operations; harness/spans.py)."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, *spans.phase_spans("animation"))
