"""physics.device_ms: device time of the physics module's two phases
(physics/module.py: update_parallel, the contact stage and kernel K2 on the
pruned branch, and update, the write-back to the local transforms), by
torch.profiler, on the window's last state."""


def read(run):
    return run.phase_ms("physics", ("update_parallel", "update"))
