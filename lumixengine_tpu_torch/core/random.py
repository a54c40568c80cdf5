"""Counter-based randomness: the parts of ``jax.random`` the particle path
uses (``PRNGKey``, ``fold_in``, ``split``, ``bits``, ``uniform``), bit for bit.

The generator is threefry2x32 in JAX's partitionable mode
(``jax_threefry_partitionable = True``): element ``i`` of a draw of shape S
hashes the 64-bit counter ``i`` (row-major over S), split into its high and
low 32-bit words, under the key, and the two output words are XORed.

A key is an integer tensor ``[..., 2]`` of two uint32 words; a leading batch
``[...]`` gives one key per world, as ``vmap`` over keys does in the
reference. torch has no full uint32 arithmetic, so the words are held in
int64 and masked to 32 bits after every add and shift. Keys may come in as
uint32, int32 (bit pattern) or int64; ``fold_in`` returns int64 keys.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _words(x: torch.Tensor) -> torch.Tensor:
    """32-bit words as int64 in [0, 2^32). uint32 is read through an int32
    view: torch has few uint32 kernels."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x0, x1) under
    the key (k0, k1); all int64 tensors of 32-bit words, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: [0, seed mod 2^32],
    as uint32 ``[2]`` (made as int32 bits and viewed)."""
    low = int(seed) & MASK
    return torch.tensor([0, low - (1 << 32) if low >= 1 << 31 else low], dtype=torch.int32,
                        device=device).view(torch.uint32)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the uint32 value of `data` (a Python int
    or an integer tensor broadcasting against the key batch, e.g. a per-world
    frame counter) under `key` [..., 2] → int64 key [..., 2]."""
    key = _words(key)
    # a Python int stays a host scalar: no host-to-device copy per call
    d = int(data) & MASK if isinstance(data, int) else _words(data.to(key.device))
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` in partitionable mode: key i is the
    hash of the counter (0, i), the same words as ``fold_in(key, i)`` →
    int64 keys [num, 2]."""
    key = _words(key)
    i = torch.arange(int(num), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, i)
    return torch.stack([y0, y1], dim=-1)


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words as int64) for a key
    batch [..., 2] → [..., *shape]."""
    key = _words(key)
    shape = tuple(int(s) for s in shape)
    counts = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    y0, y1 = threefry2x32(key[..., 0].reshape(lead), key[..., 1].reshape(lead),
                          counts >> 32, counts & MASK)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1): the top 23
    bits of each word as the mantissa of a float in [1, 2), minus 1."""
    b = (bits(key, shape) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0
