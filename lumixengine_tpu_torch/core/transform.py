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

    @staticmethod
    def identity(n: int, batch_shape=(), dtype=torch.float32, device=None) -> "Transform":
        """`n` identity lanes, with leading `batch_shape` axes."""
        bs = tuple(batch_shape)
        rot = torch.zeros(bs + (4, n), dtype=dtype, device=device)
        rot[..., 3, :] = 1.0
        return Transform(pos=torch.zeros(bs + (3, n), dtype=dtype, device=device), rot=rot,
                         scale=torch.ones(bs + (3, n), dtype=dtype, device=device))

    @property
    def lanes(self) -> int:
        """N, the entity, bone or instance axis."""
        return self.pos.shape[-1]

    def packed(self) -> torch.Tensor:
        """[..., 10, N] concatenation (pos|rot|scale): one gather moves all."""
        return torch.cat([self.pos, self.rot, self.scale], dim=AXIS)

    @staticmethod
    def from_packed(p: torch.Tensor) -> "Transform":
        return Transform(pos=p[..., 0:3, :], rot=p[..., 3:7, :], scale=p[..., 7:10, :])


def compose(a: Transform, b: Transform) -> Transform:
    """a ∘ b — apply b in a's space (parent ∘ local = global)."""
    return Transform(
        pos=a.pos + lm.quat_rotate(a.rot, b.pos * a.scale, axis=AXIS),
        rot=lm.quat_mul(a.rot, b.rot, axis=AXIS),
        scale=a.scale * b.scale,
    )


def inverse(t: Transform) -> Transform:
    """The transform undoing `t` (exact for uniform scale)."""
    inv_rot = lm.quat_conjugate(t.rot, axis=AXIS)
    inv_scale = 1.0 / t.scale
    return Transform(
        pos=lm.quat_rotate(inv_rot, -t.pos, axis=AXIS) * inv_scale,
        rot=inv_rot,
        scale=inv_scale,
    )


def compute_local(parent: Transform, child_global: Transform) -> Transform:
    """Local l such that compose(parent, l) == child_global."""
    inv_rot = lm.quat_conjugate(parent.rot, axis=AXIS)
    return Transform(
        pos=lm.quat_rotate(inv_rot, child_global.pos - parent.pos, axis=AXIS) / parent.scale,
        rot=lm.quat_mul(inv_rot, child_global.rot, axis=AXIS),
        scale=child_global.scale / parent.scale,
    )


def transform_point(t: Transform, p: torch.Tensor) -> torch.Tensor:
    return t.pos + lm.quat_rotate(t.rot, p * t.scale, axis=AXIS)


def transform_vector(t: Transform, v: torch.Tensor) -> torch.Tensor:
    return lm.quat_rotate(t.rot, v, axis=AXIS)


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
