"""CoreModule — Spline + Signal components (≙ reference engine/core.{h,cpp}).

Reference: Spline = per-entity Vec3 point array (sampled by particles' SPLINE
instruction and editor tools); Signal = connects a reflected EVENT on one
component to a reflected FUNCTION on another (core.cpp signal dispatch).

Splines are baked into a device bank (padded [3, max_pts, S] + arc-length
tables) so batched code can sample them (`sample_spline`); signals connect
through the reflection registry and are dispatched host-side between frames
(events are host-visible by design — device-side state changes surface
through counters/masks). The port's counterpart of
``lumixengine_tpu/engine/core_module.py``: the bank holds tensors on the
module's device (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from dataclasses import dataclass

import numpy as np
import torch

from lumixengine_tpu_torch.engine.plugin import IModule, ISystem
from lumixengine_tpu_torch.engine.world import World
from lumixengine_tpu_torch.engine import reflection


@dataclass
class SplineBank:
    """Device spline bank: points [3, P, S] (padded), arc params for sampling."""

    points: torch.Tensor      # f32 [3, P, S]
    count: torch.Tensor       # int32 [S] points used
    seg_len: torch.Tensor     # f32 [P-1, S] per-segment lengths
    total_len: torch.Tensor   # f32 [S]


def _along(x, idx):
    """x [..., P, K] gathered along -2 at idx [..., K] → [..., K] (x's
    leading axes broadcast to idx's)."""
    lead = torch.broadcast_shapes(x.shape[:-2], idx.shape[:-1])
    xb = x.expand(lead + x.shape[-2:])
    return torch.gather(xb, -2, idx.expand(lead + idx.shape[-1:])[..., None, :])[..., 0, :]


def sample_spline(bank: SplineBank, spline_idx, t):
    """Sample splines `spline_idx` [K] at normalized arc parameters t [..., K]
    in [0, 1] → [..., 3, K] (≙ the particle VM's SPLINE instruction,
    particle_system.cpp)."""
    si = torch.as_tensor(spline_idx, device=bank.points.device).long()
    pts = bank.points.index_select(-1, si)                 # [3, P, K]
    seg = bank.seg_len.index_select(-1, si)                # [P-1, K]
    total = bank.total_len.index_select(-1, si)            # [K]
    want = torch.clamp(t, 0.0, 1.0) * total
    cum = torch.cumsum(seg, dim=-2)
    # segment index = count of completed segments before `want`
    idx = (cum <= want[..., None, :]).to(torch.int32).sum(dim=-2)
    nseg = torch.clamp_min(bank.count.index_select(-1, si) - 1, 1)
    idx = torch.minimum(torch.clamp_min(idx, 0), nseg - 1).long()
    prev_cum = torch.where(idx > 0, _along(cum, torch.clamp_min(idx - 1, 0)), 0.0)
    seg_l = _along(seg, idx)
    frac = torch.where(seg_l > 1e-9, (want - prev_cum) / seg_l, 0.0)
    p0 = torch.stack([_along(pts[c], idx) for c in range(3)], dim=-2)
    p1 = torch.stack([_along(pts[c], idx + 1) for c in range(3)], dim=-2)
    return p0 + (p1 - p0) * frac[..., None, :]


class CoreModule(IModule):
    name = "core"
    COMPONENT_STORES: Dict[str, str] = {}

    def __init__(self, world: World, system: "CoreSystem", max_points: int = 64):
        super().__init__(world, system)
        self.max_points = max_points
        self.splines: Dict[int, np.ndarray] = {}    # entity -> [n,3] points
        self.signals: Dict[int, dict] = {}          # entity -> connection spec
        self._bank: Optional[SplineBank] = None
        self.device = torch.device("cuda")          # where the bank lives

    # -- components -----------------------------------------------------------

    def component_types(self) -> List[str]:
        return ["spline", "signal"]

    def create_component(self, entity: int, ctype: str, **props):
        if ctype == "spline":
            pts = np.asarray(props.get("points", np.zeros((0, 3))), np.float32)
            self.splines[entity] = pts.reshape(-1, 3)
            self._bank = None
        elif ctype == "signal":
            # ≙ core.cpp Signal: event on one reflected component triggers a
            # reflected function
            self.signals[entity] = {
                "event_component": props.get("event_component", ""),
                "event": props.get("event", ""),
                "function_component": props.get("function_component", ""),
                "function": props.get("function", ""),
                "target_entity": int(props.get("target_entity", entity)),
            }
        else:
            raise KeyError(ctype)

    def destroy_component(self, entity: int, ctype: str) -> None:
        if ctype == "spline":
            self.splines.pop(entity, None)
            self._bank = None
        elif ctype == "signal":
            self.signals.pop(entity, None)

    def set_spline_points(self, entity: int, points) -> None:
        self.splines[entity] = np.asarray(points, np.float32).reshape(-1, 3)
        self._bank = None

    def prepare_statics(self, device) -> None:
        device = torch.device(device)
        if device != self.device:
            self.device, self._bank = device, None

    # -- spline bank -------------------------------------------------------------

    def spline_index(self, entity: int) -> int:
        return sorted(self.splines.keys()).index(entity)

    @property
    def bank(self) -> SplineBank:
        """The bank on the module's device (``prepare_statics`` sets it)."""
        if self._bank is None:
            ids = sorted(self.splines.keys())
            s = max(len(ids), 1)
            p = self.max_points
            pts = np.zeros((3, p, s), np.float32)
            count = np.ones(s, np.int32)
            seg = np.zeros((p - 1, s), np.float32)
            total = np.ones(s, np.float32)
            for i, e in enumerate(ids):
                arr = self.splines[e][:p]
                n = arr.shape[0]
                if n == 0:
                    continue
                pts[:, :n, i] = arr.T
                # pad tail with the last point so clamped sampling is safe
                pts[:, n:, i] = arr[-1][:, None]
                count[i] = n
                if n > 1:
                    d = np.linalg.norm(np.diff(arr, axis=0), axis=-1)
                    seg[: n - 1, i] = d
                    total[i] = max(d.sum(), 1e-9)
            d = self.device
            self._bank = SplineBank(
                points=torch.as_tensor(pts, device=d), count=torch.as_tensor(count, device=d),
                seg_len=torch.as_tensor(seg, device=d), total_len=torch.as_tensor(total, device=d),
            )
        return self._bank

    # -- signals (host-side dispatch, ≙ core.cpp:120-138) --------------------------

    def dispatch_signals(self, events: List[dict]) -> int:
        """events: [{"component": str, "event": str, "entity": int}, ...] —
        fires connected reflected functions. Returns dispatch count.

        Both ends of a connection may be scoped by COMPONENT name or (as .unv
        files store them, core.cpp serializing the owning module) by MODULE
        name — either resolves through the registry (reflection.find_event /
        find_function, ≙ the reference's module-scoped reflection)."""
        reg = reflection.registry
        fired = 0
        for ev in events:
            ev_scope = ev.get("component") or ev.get("module")
            ev_canon = reg.find_event(ev_scope, ev.get("event", "")) or ev_scope
            for sig_entity, sig in self.signals.items():
                sig_canon = (reg.find_event(sig["event_component"], sig["event"])
                             or sig["event_component"])
                if (sig_canon == ev_canon and sig["event"] == ev.get("event")
                        and (ev.get("entity") is None or ev["entity"] == sig_entity)):
                    hit = reg.find_function(sig["function_component"],
                                            sig["function"])
                    if hit is None:
                        continue
                    fdef, mname = hit
                    module = self.world.modules.get(mname)
                    fdef.fn(module, sig["target_entity"])
                    fired += 1
        return fired

    # -- serialization ---------------------------------------------------------

    def serialize_components(self):
        out = []
        for e, pts in self.splines.items():
            out.append({"type": "spline", "entity": e, "props": {"points": pts.tolist()}})
        for e, sig in self.signals.items():
            out.append({"type": "signal", "entity": e, "props": dict(sig)})
        return out


class CoreSystem(ISystem):
    """≙ engine.cpp createCorePlugin."""

    name = "core_system"

    def create_modules(self, world: World) -> CoreModule:
        return CoreModule(world, self)
