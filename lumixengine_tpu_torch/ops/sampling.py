"""Clip sampling (counterpart of ``lumixengine_tpu/ops/sampling.py``).

The reference samples a batch of animators as one matmul of the clip table
with a weighted two-hot matrix. Here the same numbers come from a gather of
the two frames each animator reads and a lerp: column a gets
``table[f0]·(1-α)·w + table[f1]·α·w``. No matmul is involved, so the result
does not depend on the TF32 settings. Clip quats are sign-coherent along
time (baked), so lerp + normalize is an nlerp.

``statics`` is the clip bank's ``ClipBankStatics.on(device)``: per-clip
offset, frame count, fps and length as tensors. ``two_hot`` and
``sample_bank`` are the reference's matrix form, kept for callers of it.
"""
from __future__ import annotations

import torch


def frame_weights(time_s: torch.Tensor, clip_ids: torch.Tensor, statics, weight=None,
                  looping: bool = True):
    """time_s [..., A] seconds, clip_ids int [A] or [..., A] →
    (flat0, flat1, w0, w1) [..., A]: bank frame indices and their weights."""
    cid = torch.clamp_min(clip_ids, 0)
    off = statics.clip_offset[cid]
    nframes = statics.clip_frames[cid]
    fps = statics.clip_fps[cid]
    length = statics.clip_length[cid]
    t = torch.remainder(time_s, length) if looping else torch.clamp(time_s, 0.0, length)
    ff = t * fps
    f0 = torch.floor(ff).to(torch.int64)
    f0 = torch.minimum(torch.clamp_min(f0, 0), nframes - 1)
    f1 = torch.minimum(f0 + 1, nframes - 1)
    a = ff - f0.to(torch.float32)
    w = torch.ones_like(t) if weight is None else weight
    w = w * (clip_ids >= 0).to(torch.float32)
    return off + f0, off + f1, (1.0 - a) * w, a * w


def two_hot(flat0, flat1, w0, w1, num_cols: int) -> torch.Tensor:
    """The reference's weighted two-hot matrix [CF, A]: column a holds w0[a]
    at row flat0[a] and w1[a] at row flat1[a] (summed where they meet)."""
    cols = torch.arange(num_cols, device=flat0.device)[:, None]
    m = torch.where(cols == flat0[None, :], w0[None, :], 0.0)
    return m + torch.where(cols == flat1[None, :], w1[None, :], 0.0)


def sample_bank(table: torch.Tensor, weights_cf_a: torch.Tensor) -> torch.Tensor:
    """pose [rows, A] = table [rows, CF] @ weights [CF, A], a float32 matrix
    product. The reference asks its MXU for the full float32 mantissa
    (Precision.HIGHEST); PyTorch gives the same while TF32 matmul stays off,
    which is its default, and the port never turns it on."""
    return torch.matmul(table.to(torch.float32), weights_cf_a.to(torch.float32))


def sample_frames(table_t: torch.Tensor, f0, f1, w0, w1) -> torch.Tensor:
    """table_t [CF, R] (frame-major) → [..., R, A] = Σ of the two weighted
    frames per column."""
    out = table_t[f0] * w0.unsqueeze(-1) + table_t[f1] * w1.unsqueeze(-1)  # [..., A, R]
    return out.transpose(-1, -2)


def _normalized(rot: torch.Tensor, axis: int) -> torch.Tensor:
    return rot * torch.rsqrt(torch.clamp_min(torch.sum(rot * rot, dim=axis, keepdim=True), 1e-12))


def sample_clips(bank, time_s, clip_ids, statics, weight=None, looping: bool = True,
                 normalize_rot: bool = True):
    """→ (pos [..., 3, B, A], rot [..., 4, B, A]) local-space sampled pose;
    `bank` is ``ClipBank.on(device)``. With `weight` the result is
    pre-scaled by it."""
    f0, f1, w0, w1 = frame_weights(time_s, clip_ids, statics, weight=weight, looping=looping)
    out = sample_frames(bank.table_t, f0, f1, w0, w1)  # [..., 7*B, A]
    b = out.shape[-2] // 7
    out = out.reshape(out.shape[:-2] + (7, b, out.shape[-1]))
    pos = out[..., 0:3, :, :]
    rot = out[..., 3:7, :, :]
    return pos, _normalized(rot, -3) if normalize_rot else rot


def sample_root_motion(bank, time_s, clip_ids, statics, looping: bool = True):
    """The per-clip root-motion track (root transform against frame 0) →
    (pos [..., 3, A], rot [..., 4, A]); the module differences two samples
    to get the frame's root motion."""
    f0, f1, w0, w1 = frame_weights(time_s, clip_ids, statics, looping=looping)
    out = sample_frames(bank.root_t, f0, f1, w0, w1)  # [..., 7, A]
    return out[..., 0:3, :], _normalized(out[..., 3:7, :], -2)
