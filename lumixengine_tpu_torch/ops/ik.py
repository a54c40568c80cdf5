"""FABRIK inverse kinematics (counterpart of ``lumixengine_tpu/ops/ik.py``):
5 iterations, chains of at most 32 bones, alpha-blended into the pose.

The whole animator batch solves at once. Chain joint positions are
[..., 3, L, A] (L = chain length, A animator lanes); bone lengths come from
the input chain. Each iteration is one backward and one forward pass over
the chain, a Python loop over its joints.
"""
from __future__ import annotations

import torch

from lumixengine_tpu_torch.core import math as lm

MAX_CHAIN = 32
DEFAULT_ITERATIONS = 5


def _norm_dir(v, eps=1e-9):
    """v scaled by the inverse norm over axis -2, as the reference's."""
    return v * torch.rsqrt(torch.clamp_min(torch.sum(v * v, dim=-2, keepdim=True), eps))


def fabrik(joints, target, iterations: int = DEFAULT_ITERATIONS):
    """Solve chain positions joints [..., 3, L, A] (model space) toward
    target [..., 3, A], the root fixed → [..., 3, L, A]. An unreachable
    target stretches the chain toward it."""
    L = joints.shape[-2]
    root = joints[..., :, 0, :]
    seg = joints[..., :, 1:, :] - joints[..., :, :-1, :]
    lengths = torch.sqrt(torch.clamp_min(torch.sum(seg * seg, dim=-3, keepdim=True), 1e-12))
    p = list(joints.unbind(-2))                       # L joints of [..., 3, A]
    target = target.expand(p[0].shape)
    for _ in range(iterations):
        # backward: effector → root, the effector pinned to the target
        p[L - 1] = target
        for i in range(L - 2, -1, -1):
            d = _norm_dir(p[i] - p[i + 1])
            p[i] = p[i + 1] + d * lengths[..., :, i, :]
        # forward: root → effector, the root pinned
        p[0] = root
        for i in range(1, L):
            d = _norm_dir(p[i] - p[i - 1])
            p[i] = p[i - 1] + d * lengths[..., :, i - 1, :]
    return torch.stack(p, dim=-2)


def chain_rotation_deltas(old_joints, new_joints):
    """Per-joint rotation deltas taking the old bone directions to the solved
    ones → quaternions [..., 4, L-1, A] (composed into the pose's absolute
    rotations). The directions are scaled over axis -2 (the bone axis here),
    as the reference scales them."""
    d_old = _norm_dir(old_joints[..., :, 1:, :] - old_joints[..., :, :-1, :])
    d_new = _norm_dir(new_joints[..., :, 1:, :] - new_joints[..., :, :-1, :])
    # shortest-arc quaternion between two directions
    c = lm.cross(d_old, d_new, axis=-3)
    d = torch.sum(d_old * d_new, dim=-3, keepdim=True)
    w = 1.0 + d
    q = torch.cat([c, w], dim=-3)
    # opposite directions: a perpendicular axis instead
    opp = w < 1e-6
    bias = torch.tensor([1.0, 0.3, 0.7], dtype=d_old.dtype, device=d_old.device)[:, None, None]
    perp = _norm_dir(lm.cross(d_old, torch.ones_like(d_old) * bias, axis=-3))
    q = torch.where(opp, torch.cat([perp, torch.zeros_like(w)], dim=-3), q)
    return lm.quat_normalize(q, axis=-3)


def apply_ik(joints, target, alpha, iterations: int = DEFAULT_ITERATIONS):
    """FABRIK, then a blend toward the solution by alpha (a number or a
    per-animator [..., A] row)."""
    solved = fabrik(joints, target, iterations)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=joints.device)
    if a.dim() == joints.dim() - 2:
        a = a.unsqueeze(-2).unsqueeze(-2)
    return joints + (solved - joints) * a
