"""Skinning palettes and vertex skinning (counterpart of
``lumixengine_tpu/ops/skinning.py``): absolute pose ∘ inverse bind, as dual
quaternions, for a whole animator batch in one elementwise pass over
[..., 8, B, A]; the dual-quaternion blend of each vertex's bones with the
model's static [B, V] weight matrix; and the blended dual quaternions
applied to rest positions."""
from __future__ import annotations

import numpy as np
import torch

from lumixengine_tpu_torch.core import math as lm

AX = -3  # component axis for [C, B, A] pose tensors


def build_palette_dq(abs_pos, abs_rot, inv_bind_pos, inv_bind_rot):
    """Dual-quat palette [..., 8, B, A] from the absolute pose [..., 3/4, B, A]
    and the model's inverse bind pose [3/4, B] (broadcast over A)."""
    ibp = inv_bind_pos if inv_bind_pos.dim() >= abs_pos.dim() else inv_bind_pos.unsqueeze(-1)
    ibr = inv_bind_rot if inv_bind_rot.dim() >= abs_rot.dim() else inv_bind_rot.unsqueeze(-1)
    pos = abs_pos + lm.quat_rotate(abs_rot, ibp, axis=AX)
    rot = lm.quat_mul(abs_rot, ibr, axis=AX)
    return lm.dual_quat_from_rigid(rot, pos, axis=AX)


def blend_palette(palette_dq: torch.Tensor, weights_bv) -> torch.Tensor:
    """Dual-quaternion blend: palette [..., 8, B, A] ⊗ weights [B, V] →
    [..., 8, V, A]. Each bone's dual quat is flipped onto the hemisphere of
    bone 0's real part (per animator), blended by the weights (at most 4
    nonzero per column), then normalized. The blend is a float32 matrix
    product; TF32 matmul stays off (PyTorch's default), so every product
    keeps the full float32 mantissa."""
    w = torch.as_tensor(weights_bv, dtype=palette_dq.dtype, device=palette_dq.device)
    ref = palette_dq[..., :4, 0:1, :]
    d = torch.sum(palette_dq[..., :4, :, :] * ref, dim=-3, keepdim=True)
    pal = torch.where(d < 0.0, -palette_dq, palette_dq)
    blended = torch.matmul(pal.transpose(-1, -2), w).transpose(-1, -2)   # [..., 8, V, A]
    return lm.dual_quat_normalize(blended, axis=AX)


def skin_points(blended_dq: torch.Tensor, rest_points) -> torch.Tensor:
    """Blended dual quats [..., 8, V, A] applied to rest positions [3, V]
    → skinned positions [..., 3, V, A]."""
    p = torch.as_tensor(rest_points, dtype=blended_dq.dtype, device=blended_dq.device)
    if p.dim() < blended_dq.dim():
        p = p.unsqueeze(-1)
    return lm.dual_quat_transform(blended_dq, p, axis=AX)


def weights_matrix(vertex_bones: np.ndarray, vertex_weights: np.ndarray,
                   num_bones: int) -> np.ndarray:
    """Static [B, V] weight matrix from per-vertex (at most 4 bones, weights)."""
    vb = np.asarray(vertex_bones, np.int64)
    vw = np.asarray(vertex_weights, np.float32)
    v = vb.shape[0]
    m = np.zeros((num_bones, v), np.float32)
    for k in range(vb.shape[1]):
        m[vb[:, k], np.arange(v)] += vw[:, k]
    return m
