"""Pose ops (counterpart of ``lumixengine_tpu/ops/pose.py``).

A batch of poses is pos [..., 3, B, A], rot [..., 4, B, A]: channels major,
bones middle, animator lanes minor. The absolute compose is a level scan
over the skeleton's depth levels (a static per-model bone plan shared by
every animator of the model); each level is one row gather + rigid compose
over all lanes. Bones are rigid (no scale).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from lumixengine_tpu_torch.core import math as lm


class BonePlan:
    """Static per-skeleton schedule: [(child_rows np[K], parent_rows np[K])]
    per depth level (roots excluded), and their index tensors per device."""

    def __init__(self, bone_parent: np.ndarray):
        bone_parent = np.asarray(bone_parent, np.int32)
        b = bone_parent.shape[0]
        level = np.zeros(b, np.int32)
        for i in range(b):
            p = bone_parent[i]
            level[i] = 0 if p < 0 else level[p] + 1
        self.levels: List[Tuple[np.ndarray, np.ndarray]] = []
        for d in range(1, int(level.max(initial=0)) + 1):
            idx = np.nonzero(level == d)[0].astype(np.int32)
            self.levels.append((idx, bone_parent[idx]))
        self.bone_level = level
        self._dev: Dict[str, list] = {}

    def on(self, device) -> list:
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = [(torch.as_tensor(c.astype(np.int64), device=device),
                               torch.as_tensor(p.astype(np.int64), device=device))
                              for c, p in self.levels]
        return self._dev[key]


def _rigid_compose(ppos, prot, lpos, lrot):
    """(R1,p1) ∘ (R2,p2) = (R1·R2, p1 + R1·p2), SoA over [..., C, K, A]."""
    return ppos + lm.quat_rotate(prot, lpos, axis=-3), lm.quat_mul(prot, lrot, axis=-3)


def compute_absolute(pos: torch.Tensor, rot: torch.Tensor, plan: BonePlan):
    """Relative (local per bone) → absolute (model space) pose.
    pos [..., 3, B, A], rot [..., 4, B, A]."""
    apos, arot = pos, rot
    for ci, pi in plan.on(pos.device):
        npos, nrot = _rigid_compose(apos.index_select(-2, pi), arot.index_select(-2, pi),
                                    pos.index_select(-2, ci), rot.index_select(-2, ci))
        apos = apos.index_copy(-2, ci, npos)
        arot = arot.index_copy(-2, ci, nrot)
    return apos, arot


def blend(pos_a, rot_a, pos_b, rot_b, t):
    """Pose blend: lerp positions + nlerp rotations. t: a number or a
    per-animator weight [..., A]."""
    if isinstance(t, torch.Tensor) and t.dim() == pos_a.dim() - 2:
        t = t.unsqueeze(-2).unsqueeze(-2)
    pos = pos_a + (pos_b - pos_a) * t
    d = torch.sum(rot_a * rot_b, dim=-3, keepdim=True)
    rot_b = torch.where(d < 0.0, -rot_b, rot_b)
    rot = rot_a + (rot_b - rot_a) * t
    norm = torch.rsqrt(torch.clamp_min(torch.sum(rot * rot, dim=-3, keepdim=True), 1e-12))
    return pos, rot * norm


def masked_blend(pos_a, rot_a, pos_b, rot_b, t, bone_mask):
    """Blend with a per-bone mask [B] (bool tensor): masked-out bones keep
    pose A."""
    pos, rot = blend(pos_a, rot_a, pos_b, rot_b, t)
    m = bone_mask.to(torch.bool).unsqueeze(-1)
    return torch.where(m, pos, pos_a), torch.where(m, rot, rot_a)
