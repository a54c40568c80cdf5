"""Batched vector/quaternion math on tensors (counterpart of
``lumixengine_tpu/core/math.py``).

Layout as in the reference: large arrays are struct-of-arrays with the
entity axis last, vectors ``[..., 3, N]`` and quaternions ``[..., 4, N]`` in
(x, y, z, w) order; small values use the component axis -1. Every function
takes ``axis=`` for the component axis. The order of floating-point
operations follows the reference term by term.
"""
from __future__ import annotations

import math

import torch


def unstack(a: torch.Tensor, axis: int = -1):
    return a.unbind(axis)


def stack(components, axis: int = -1):
    return torch.stack(list(components), dim=axis)


def _scalar(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def vec3(x, y, z, dtype=torch.float32, axis: int = -1, device=None):
    """Stack three components (numbers or tensors) on `device`."""
    return torch.stack([_scalar(x, dtype, device), _scalar(y, dtype, device),
                        _scalar(z, dtype, device)], dim=axis)


def dot(a, b, axis: int = -1):
    return torch.sum(a * b, dim=axis)


def cross(a, b, axis: int = -1):
    ax, ay, az = unstack(a, axis)
    bx, by, bz = unstack(b, axis)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=axis)


def length(v, axis: int = -1):
    return torch.sqrt(torch.clamp_min(dot(v, v, axis), 0.0))


def squared_length(v, axis: int = -1):
    return dot(v, v, axis)


def lerp(a, b, t):
    return a + (b - a) * t


def normalize(v, axis: int = -1, eps: float = 1e-12):
    """Safe normalize: v * rsqrt(|v|^2); zero vectors stay finite."""
    sq = torch.clamp_min(dot(v, v, axis), eps)
    return v * torch.rsqrt(sq).unsqueeze(axis)


# quaternions — component order (x, y, z, w)

QUAT_IDENTITY = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32)


def quat_identity(batch_shape=(), dtype=torch.float32, axis: int = -1, device=None):
    """Identity quaternions [*batch_shape, 4] on `device` (component axis -1
    only: the SoA form broadcasts QUAT_IDENTITY instead)."""
    if axis != -1:
        raise ValueError("quat_identity only supports axis=-1; broadcast QUAT_IDENTITY for SoA")
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def quat(x, y, z, w, dtype=torch.float32, axis: int = -1, device=None):
    """Stack four components (numbers or tensors) on `device`."""
    return torch.stack([_scalar(c, dtype, device) for c in (x, y, z, w)], dim=axis)


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


def quat_from_axis_angle(axis_v, angle, axis: int = -1):
    """axis_v must be normalized; angle in radians."""
    half = torch.as_tensor(angle, dtype=torch.float32, device=axis_v.device) * 0.5
    s, c = torch.sin(half), torch.cos(half)
    x, y, z = unstack(axis_v, axis)
    return torch.stack([x * s, y * s, z * s, c], dim=axis)


def quat_from_euler(pitch, yaw, roll, device=None):
    """Euler (pitch = X, yaw = Y, roll = Z) → quat, intrinsic Y·X·Z as in
    the reference."""
    eye = torch.eye(3, dtype=torch.float32, device=device)
    qx = quat_from_axis_angle(eye[0], _scalar(pitch, torch.float32, device))
    qy = quat_from_axis_angle(eye[1], _scalar(yaw, torch.float32, device))
    qz = quat_from_axis_angle(eye[2], _scalar(roll, torch.float32, device))
    return quat_mul(qy, quat_mul(qx, qz))


def quat_slerp(a, b, t, axis: int = -1):
    """Spherical lerp with the nlerp form for nearly parallel quats."""
    t = torch.as_tensor(t, dtype=torch.float32, device=a.device)
    d = torch.sum(a * b, dim=axis)
    b = torch.where(d.unsqueeze(axis) < 0.0, -b, b)
    d = torch.clamp_max(torch.abs(d), 1.0 - 1e-7)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    tb = torch.broadcast_to(t, d.shape)
    wa = torch.sin((1.0 - tb) * theta) / sin_theta
    wb = torch.sin(tb * theta) / sin_theta
    use_slerp = d < 0.9995
    wa = torch.where(use_slerp, wa, 1.0 - tb)
    wb = torch.where(use_slerp, wb, tb)
    return quat_normalize(a * wa.unsqueeze(axis) + b * wb.unsqueeze(axis), axis)


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


def dual_quat_transform(dq, v, axis: int = -1):
    """Apply dual quaternion(s) [..., 8, ...] to points [..., 3, ...]."""
    real, dual = torch.split(dq, 4, dim=axis)
    tx, ty, tz, _ = unstack(quat_mul(dual, quat_conjugate(real, axis), axis), axis)
    trans = torch.stack([2.0 * tx, 2.0 * ty, 2.0 * tz], dim=axis)
    return quat_rotate(real, v, axis) + trans


def dual_quat_normalize(dq, axis: int = -1):
    """Both halves scaled by rsqrt of the real part's squared length."""
    real, dual = torch.split(dq, 4, dim=axis)
    inv_len = torch.rsqrt(torch.clamp_min(torch.sum(real * real, dim=axis, keepdim=True), 1e-12))
    return torch.cat([real * inv_len, dual * inv_len], dim=axis)


def mat3_to_quat(m):
    """3x3 rotation matrix [..., 3, 3] → quat (x, y, z, w), branch-free
    Shepperd as in the reference."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12)) * 0.5

    qw0 = root(1.0 + tr)
    q0 = torch.stack([(m21 - m12), (m02 - m20), (m10 - m01), 4.0 * qw0 * qw0], -1) / (4.0 * qw0)[..., None]
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([4.0 * qx1 * qx1, (m01 + m10), (m02 + m20), (m21 - m12)], -1) / (4.0 * qx1)[..., None]
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m01 + m10), 4.0 * qy2 * qy2, (m12 + m21), (m02 - m20)], -1) / (4.0 * qy2)[..., None]
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m02 + m20), (m12 + m21), 4.0 * qz3 * qz3, (m10 - m01)], -1) / (4.0 * qz3)[..., None]
    cond0 = tr > 0.0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = torch.where(cond0[..., None], q0,
                    torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3)))
    return quat_normalize(q)


# misc scalar helpers

def degrees_to_radians(d):
    return torch.as_tensor(d) * (math.pi / 180.0)


def radians_to_degrees(r):
    return torch.as_tensor(r) * (180.0 / math.pi)


def clamp(x, lo, hi):
    return torch.clamp(torch.as_tensor(x), lo, hi)
