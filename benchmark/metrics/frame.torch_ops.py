"""frame.torch_ops: the non-view torch operations one frame of the
program's step dispatches, counted on the host by a TorchDispatchMode (each
about one kernel launch; a hand kernel's launch through ctypes is not an
operation). Layer: the engine frame (engine/engine.py::build_step)."""
from torch.utils._python_dispatch import TorchDispatchMode


def count_ops(fn):
    """(fn(), the number of non-view torch ops it dispatched)."""

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not getattr(func, "is_view", False):
                self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        out = fn()
    return out, c.n


def read(run):
    return count_ops(lambda: run.step(run.state, run.dt))[1]
