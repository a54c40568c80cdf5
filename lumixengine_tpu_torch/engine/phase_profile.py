"""Per-phase cost model of a frame (counterpart of
``lumixengine_tpu/engine/phase_profile.py``; ≙ reference engine.cpp:285-313
frame counters and the per-module profiler scopes).

Each overridden module phase, the hierarchy propagation
(``world.propagate``) and the ``extra`` pass (``extra.cull``) run once,
standalone, on the same state, under a counter of their work: the bytes of
every tensor each dispatched op reads and writes (its tensor inputs and
outputs; view ops move nothing and are not counted) and the floating-point
operations ``torch.utils.flop_counter`` reports (matmuls and convolutions;
element-wise ops count none). A phase's time estimate is its roofline time
on one H100, ``max(flops / 67 TFLOP/s fp32, bytes / 3.35 TB/s)``, and its
``frac`` is its share of the phases' sum; the Runner splits its measured
frame time by these shares into ``phase.<k>.est_ms``. As in the reference,
the cost of an identity pass over the state is subtracted from each module
phase and from the extra pass; in the eager port that pass dispatches no op
and costs nothing.

The shares are a model, not a measurement. The port runs eagerly, so each
op's inputs and outputs count whole: the byte count is the unfused upper
bound of what the card moves (a fused kernel keeps intermediates on chip).
The reference counts XLA's fused programs, so the two packages' fractions
differ; only the keys and the sum of ``frac`` (1) are shared.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

# one H100 SXM at its 700 W limit (NVIDIA's data sheet), as PERF.md's bounds use
PEAK_F32 = 67e12
HBM_BPS = 3.35e12

PHASES = ("end_frame", "update_parallel", "update", "late_update")


def _phase_overridden(module, phase: str) -> bool:
    from lumixengine_tpu_torch.engine.plugin import IModule

    return getattr(type(module), phase, None) is not getattr(IModule, phase)


def _is_view(func) -> bool:
    is_view = getattr(func, "is_view", None)
    if is_view is not None:
        return bool(is_view)
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of each dispatched op's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_view(func):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _est(flops: float, nbytes: float) -> Dict[str, float]:
    return {"flops": flops, "bytes": nbytes,
            "est_s": max(flops / PEAK_F32, nbytes / HBM_BPS)}


def cost_of(fn: Callable, state, dt) -> Dict[str, float]:
    """{flops, bytes, est_s} of one call fn(state, dt)."""
    bc = _ByteCounter()
    with FlopCounterMode(display=False) as fc, bc:
        fn(state, dt)
    return _est(float(fc.get_total_flops()), float(bc.bytes))


def profile_phases(world, state, dt: float = 1.0 / 60.0,
                   extra=None) -> Dict[str, Dict[str, float]]:
    """{"<module>.<phase>": {flops, bytes, est_s, frac}} for every
    overridden module phase, plus "world.propagate" and, with an `extra`
    pass, "extra.cull"; each run once on `state` (on its device)."""
    from lumixengine_tpu_torch.ops import hierarchy as hier

    device = state.local.pos.device
    dt = torch.as_tensor(dt, dtype=torch.float32, device=device)
    for m in world.modules.values():
        m.prepare_statics(device)
    ident = cost_of(lambda s, d: s, state, dt)

    def marginal(cost):
        return _est(max(cost["flops"] - ident["flops"], 0.0),
                    max(cost["bytes"] - ident["bytes"], 0.0))

    out: Dict[str, Dict[str, float]] = {}
    for m in world.modules.values():
        for phase in PHASES:
            if _phase_overridden(m, phase):
                out[f"{m.name}.{phase}"] = marginal(cost_of(getattr(m, phase), state, dt))
    plan = world.plan
    out["world.propagate"] = cost_of(lambda s, d: hier.propagate_plan(s.local, plan), state, dt)
    if extra is not None:
        out["extra.cull"] = marginal(cost_of(extra, state, dt))
    total = sum(c["est_s"] for c in out.values()) or 1.0
    for c in out.values():
        c["frac"] = c["est_s"] / total
    return out


def attribute_frame(profile: Dict[str, Dict[str, float]], frame_ms: float) -> Dict[str, float]:
    """A measured frame time split across the phases by their fractions →
    {"<module>.<phase>_est_ms": ms}. The _est_ suffix is the contract: these
    are modelled shares of a measured total, not per-phase measurements."""
    return {f"{k}_est_ms": profile[k]["frac"] * frame_ms for k in profile}
