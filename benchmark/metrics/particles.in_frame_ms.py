"""particles.in_frame_ms: device time a frame of the render module's update
inside the frame step (the span renderer.update, which runs the particle
emitters' scripts: the scope of particles.device_ms; harness/spans.py).
None for a world without an emitter."""
from benchmark.harness import spans


def read(run):
    if not run.scene.renderer.particle_emitters:
        return None
    return spans.device_ms(run, "renderer.update")
