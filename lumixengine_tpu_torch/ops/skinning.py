"""Skinning palettes (counterpart of ``build_palette_dq`` in
``lumixengine_tpu/ops/skinning.py``): absolute pose ∘ inverse bind, as dual
quaternions, for a whole animator batch in one elementwise pass over
[..., 8, B, A]."""
from __future__ import annotations

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
