"""animation.device_ms: device time of the animation module's two phases
(animation/module.py: update_parallel, the animators, and update, the
animables), by torch.profiler, on the window's last state."""


def read(run):
    return run.phase_ms("animation", ("update_parallel", "update"))
