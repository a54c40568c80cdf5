"""Small plain building blocks of the reference: vector and quaternion
algebra with the components on one axis (quaternions as x, y, z, w), and
the Threefry-2x32 counter hash with the key derivation and uniform draws
the particle scripts use.

Threefry-2x32 (20 rounds) is the Random123 hash (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011). Keys and counters follow
jax.random's conventions in its partitionable mode: a key is two 32-bit
words; ``fold_in(key, d)`` hashes the counter (0, d); draw i of a uniform
array hashes the 64-bit counter i split into (high, low) words and XORs
the two output words; a float in [0, 1) takes the top 23 bits as the
mantissa of a number in [1, 2), minus 1.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def comps(x: torch.Tensor, axis: int):
    return x.unbind(axis)


def dot(a, b, axis: int):
    return (a * b).sum(dim=axis)


def cross(a, b, axis: int):
    ax, ay, az = comps(a, axis)
    bx, by, bz = comps(b, axis)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=axis)


def qmul(a, b, axis: int):
    """The Hamilton product a * b."""
    ax, ay, az, aw = comps(a, axis)
    bx, by, bz, bw = comps(b, axis)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], dim=axis)


def qconj(q, axis: int):
    x, y, z, w = comps(q, axis)
    return torch.stack([-x, -y, -z, w], dim=axis)


def qrot(q, v, axis: int):
    """v rotated by the unit quaternion q: v + w t + q_v x t, t = 2 q_v x v."""
    qv = q.narrow(axis, 0, 3)
    w = q.narrow(axis, 3, 1)
    t = 2.0 * cross(qv, v, axis)
    return v + w * t + cross(qv, t, axis)


def normalized(q, axis: int, eps: float = 1e-12):
    return q * torch.rsqrt(torch.clamp_min(dot(q, q, axis), eps)).unsqueeze(axis)


def nlerp(a, b, t, axis: int):
    """a toward b by t, b taken on a's hemisphere, renormalised."""
    b = torch.where(dot(a, b, axis).unsqueeze(axis) < 0.0, -b, b)
    return normalized(a + (b - a) * t, axis)


# -- Threefry-2x32 ------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round hash of the counter words (x0, x1) under the key words
    (k0, k1); 32-bit words held in int64 tensors, broadcast together."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    keys = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for block in range(5):
        for r in _ROT[block % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + keys[(block + 1) % 3]) & MASK32
        x1 = (x1 + keys[(block + 2) % 3] + block + 1) & MASK32
    return x0, x1


def key_words(key: torch.Tensor) -> torch.Tensor:
    """A key [..., 2] of 32-bit words (any integer type) as int64 words."""
    if key.dtype == torch.uint32:
        key = key.view(torch.int32)
    return key.to(torch.int64) & MASK32


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """The key [..., 2] with `data` (an int, or integers [...]) folded in."""
    key = key_words(key)
    d = (int(data) & MASK32) if isinstance(data, int) else key_words(data)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(key[..., 0]), d)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """n floats in [0, 1) under each key of [..., 2] -> [..., n]."""
    key = key_words(key)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], i >> 32, i & MASK32)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
