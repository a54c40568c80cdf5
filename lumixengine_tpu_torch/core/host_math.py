"""Numpy mirrors of the quaternion/transform ops for host-side scene building.

The World builder (engine/world.py) mutates plain numpy arrays when entities are
created/reparented — device math (core/math.py) would round-trip through XLA for
every edit. Semantics are identical to core/math.py / core/transform.py.
"""
from __future__ import annotations

import numpy as np

QUAT_IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def quat_mul(a, b):
    a = np.asarray(a); b = np.asarray(b)
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    ).astype(np.float32)


def quat_conjugate(q):
    return np.asarray(q) * np.array([-1.0, -1.0, -1.0, 1.0], np.float32)


def quat_rotate(q, v):
    q = np.asarray(q); v = np.asarray(v)
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * np.cross(qv, v)
    return (v + w * t + np.cross(qv, t)).astype(np.float32)


def quat_normalize(q):
    q = np.asarray(q, np.float32)
    n = np.sqrt(np.maximum(np.sum(q * q, axis=-1, keepdims=True), 1e-24))
    return q / n


def quat_from_axis_angle(axis, angle):
    axis = np.asarray(axis, np.float32)
    angle = np.asarray(angle, np.float32)
    half = angle * 0.5
    s = np.sin(half)
    c = np.cos(half)
    return np.concatenate([axis * s[..., None], c[..., None]], axis=-1).astype(np.float32)


def compose(a_pos, a_rot, a_scale, b_pos, b_rot, b_scale):
    """SRT compose, same as core/transform.compose (≙ reference math.cpp Transform::compose)."""
    pos = a_pos + quat_rotate(a_rot, b_pos * a_scale)
    rot = quat_mul(a_rot, b_rot)
    scale = a_scale * b_scale
    return pos.astype(np.float32), rot.astype(np.float32), scale.astype(np.float32)


def compute_local(p_pos, p_rot, p_scale, g_pos, g_rot, g_scale):
    """Inverse of compose (≙ reference math.cpp Transform::computeLocal)."""
    inv_rot = quat_conjugate(p_rot)
    pos = quat_rotate(inv_rot, g_pos - p_pos) / p_scale
    rot = quat_mul(inv_rot, g_rot)
    scale = g_scale / p_scale
    return pos.astype(np.float32), rot.astype(np.float32), scale.astype(np.float32)
