"""hierarchy.device_ms: device time of the transform propagation
(ops/hierarchy.py::propagate_plan) on the window's last state's local
transforms, by torch.profiler."""
from lumixengine_tpu_torch.ops import hierarchy


def read(run):
    plan = run.scene.world.plan
    return run.device_ms(lambda: hierarchy.propagate_plan(run.state.local, plan))
