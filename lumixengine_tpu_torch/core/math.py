"""Batched vector/quaternion math on tensors (counterpart of
``lumixengine_tpu/core/math.py``).

Layout as in the reference: large arrays are struct-of-arrays with the
entity axis last, vectors ``[..., 3, N]`` and quaternions ``[..., 4, N]`` in
(x, y, z, w) order; small values use the component axis -1. Every function
takes ``axis=`` for the component axis. The order of floating-point
operations follows the reference term by term.
"""
from __future__ import annotations

import torch


def unstack(a: torch.Tensor, axis: int = -1):
    return a.unbind(axis)


def dot(a, b, axis: int = -1):
    return torch.sum(a * b, dim=axis)


def cross(a, b, axis: int = -1):
    ax, ay, az = unstack(a, axis)
    bx, by, bz = unstack(b, axis)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=axis)


def normalize(v, axis: int = -1, eps: float = 1e-12):
    """Safe normalize: v * rsqrt(|v|^2); zero vectors stay finite."""
    sq = torch.clamp_min(dot(v, v, axis), eps)
    return v * torch.rsqrt(sq).unsqueeze(axis)


def quat_mul(a, b, axis: int = -1):
    """Hamilton product a*b (apply b's rotation, then a's)."""
    ax, ay, az, aw = unstack(a, axis)
    bx, by, bz, bw = unstack(b, axis)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=axis)


def quat_conjugate(q, axis: int = -1):
    x, y, z, w = unstack(q, axis)
    return torch.stack([-x, -y, -z, w], dim=axis)


def quat_normalize(q, axis: int = -1, eps: float = 1e-12):
    sq = torch.clamp_min(torch.sum(q * q, dim=axis), eps)
    return q * torch.rsqrt(sq).unsqueeze(axis)


def quat_rotate(q, v, axis: int = -1):
    """Rotate vector(s) v by quaternion(s) q: v + 2*(w*(q×v) + q×(q×v))."""
    qx, qy, qz, qw = unstack(q, axis)
    vx, vy, vz = unstack(v, axis)
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    ox = vx + qw * tx + (qy * tz - qz * ty)
    oy = vy + qw * ty + (qz * tx - qx * tz)
    oz = vz + qw * tz + (qx * ty - qy * tx)
    return torch.stack([ox, oy, oz], dim=axis)


def quat_to_mat3(q, axis: int = -1):
    """Quaternion → 3x3 rotation matrix [..., 3, 3] (row-major, applied to
    column vectors). Component axis -1 only."""
    x, y, z, w = unstack(q, axis)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_nlerp(a, b, t, axis: int = -1):
    """Normalized lerp with hemisphere correction. `t` is a number or a
    tensor with one axis fewer than `a` (the component axis)."""
    d = torch.sum(a * b, dim=axis, keepdim=True)
    b = torch.where(d < 0.0, -b, b)
    if isinstance(t, torch.Tensor) and t.dim() == a.dim() - 1:
        t = t.unsqueeze(axis)
    return quat_normalize(a + (b - a) * t, axis)


def dual_quat_from_rigid(rot, pos, axis: int = -1):
    """(rot [..,4,..], pos [..,3,..]) → dual quat [..., 8, ...] = (real | dual)."""
    px, py, pz = unstack(pos, axis)
    pq = torch.stack([px, py, pz, torch.zeros_like(px)], dim=axis)
    dual = 0.5 * quat_mul(pq, rot, axis)
    return torch.cat([rot, dual], dim=axis)
