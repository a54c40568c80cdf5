"""SRT transform on tensors (counterpart of ``lumixengine_tpu/core/transform.py``).

``pos [..., 3, N]``, ``rot [..., 4, N]`` (x, y, z, w), ``scale [..., 3, N]``.
compose is the reference's: out.pos = a.pos + a.rot * (b.pos * a.scale),
out.rot = a.rot * b.rot, out.scale = a.scale * b.scale. It is not
associative under non-uniform scale, so callers evaluate root → leaf.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from lumixengine_tpu_torch.core import math as lm

AXIS = -2  # component axis for all Transform math


@dataclass
class Transform:
    pos: torch.Tensor
    rot: torch.Tensor
    scale: torch.Tensor

    def replace(self, **kw) -> "Transform":
        return dataclasses.replace(self, **kw)


def compose(a: Transform, b: Transform) -> Transform:
    """a ∘ b — apply b in a's space (parent ∘ local = global)."""
    return Transform(
        pos=a.pos + lm.quat_rotate(a.rot, b.pos * a.scale, axis=AXIS),
        rot=lm.quat_mul(a.rot, b.rot, axis=AXIS),
        scale=a.scale * b.scale,
    )


def take(t: Transform, idx: torch.Tensor) -> Transform:
    """Gather along the entity axis (idx: int64 [K] on t's device)."""
    return Transform(
        pos=t.pos.index_select(-1, idx),
        rot=t.rot.index_select(-1, idx),
        scale=t.scale.index_select(-1, idx),
    )


def where(mask: torch.Tensor, a: Transform, b: Transform) -> Transform:
    """mask over lanes [..., N] selects a (true) or b."""
    m = mask.unsqueeze(AXIS)
    return Transform(
        pos=torch.where(m, a.pos, b.pos),
        rot=torch.where(m, a.rot, b.rot),
        scale=torch.where(m, a.scale, b.scale),
    )
