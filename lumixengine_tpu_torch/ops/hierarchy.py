"""Transform-hierarchy propagation over a static level plan (counterpart of
``lumixengine_tpu/ops/hierarchy.py``).

Device slots are topo-sorted by the World (roots first, then level 1, ...),
so each level is a contiguous segment whose parents sit at host-known
positions. One level costs one index gather of the parents, one compose and
one slice write. The parent-position index tensors are built once per
device and cached on the plan.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from lumixengine_tpu_torch.core import transform as xf
from lumixengine_tpu_torch.core.transform import Transform


class HierarchyPlan:
    """Static propagation schedule in topo-sorted slot space: one
    (start, end, parent_pos int32[K_d]) segment per level 1..D."""

    def __init__(self, segments):
        self.segments = [(int(s), int(e), np.asarray(p, np.int32)) for (s, e, p) in segments]
        self._index: Dict[str, List[torch.Tensor]] = {}

    def __len__(self):
        return len(self.segments)

    def parent_index(self, device) -> List[torch.Tensor]:
        """The segments' parent positions as int64 tensors on `device`."""
        key = str(torch.device(device))
        if key not in self._index:
            self._index[key] = [torch.as_tensor(p.astype(np.int64), device=device)
                                for _, _, p in self.segments]
        return self._index[key]


def propagate_plan(local: Transform, plan: HierarchyPlan) -> Transform:
    """Roots' globals are their locals; each level composes its contiguous
    slice with its gathered parents, top-down. Returns new tensors; `local`
    is left untouched."""
    pos, rot, scale = local.pos.clone(), local.rot.clone(), local.scale.clone()
    for (start, end, _), pp in zip(plan.segments, plan.parent_index(pos.device)):
        if end <= start:
            continue
        parent_t = Transform(pos=pos.index_select(-1, pp), rot=rot.index_select(-1, pp),
                             scale=scale.index_select(-1, pp))
        local_t = Transform(pos=pos[..., start:end], rot=rot[..., start:end],
                            scale=scale[..., start:end])
        new_t = xf.compose(parent_t, local_t)
        pos[..., start:end] = new_t.pos
        rot[..., start:end] = new_t.rot
        scale[..., start:end] = new_t.scale
    return Transform(pos=pos, rot=rot, scale=scale)


def compute_levels_host(parent) -> Tuple[np.ndarray, int]:
    """Host-side level computation on topology change: (level int32[N],
    max_depth). Dead/root slots (parent == -1) get level 0. Raises on cycles."""
    parent = np.asarray(parent, np.int32)
    n = parent.shape[0]
    level = np.zeros(n, np.int32)
    changed = True
    rounds = 0
    while changed:
        changed = False
        mask = parent >= 0
        new_level = np.where(mask, level[np.maximum(parent, 0)] + 1, 0)
        if not np.array_equal(new_level, level):
            level = new_level.astype(np.int32)
            changed = True
        rounds += 1
        if rounds > n + 1:
            raise ValueError("cycle detected in entity hierarchy")
    return level, int(level.max(initial=0))
