"""cull.device_ms: device time of the cull pass (renderer/pipeline.py::
cull_pass through the render module: frustum cull on kernel K1, LOD, the
lights and the counters) on the window's last state, by torch.profiler."""


def read(run):
    rm = run.scene.renderer
    return run.device_ms(lambda: rm.cull_pass(run.state, run.dt_tensor))
