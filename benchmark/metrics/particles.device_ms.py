"""particles.device_ms: device time of the render module's update, which
runs the particle emitters' scripts (renderer/particle_system.py), by
torch.profiler, on the window's last state. None for a world without an
emitter."""


def read(run):
    if not run.scene.renderer.particle_emitters:
        return None
    return run.phase_ms("renderer", ("update",))
