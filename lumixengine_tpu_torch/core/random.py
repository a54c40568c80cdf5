"""Counter-based randomness: the parts of ``jax.random`` the particle path
uses (``PRNGKey``, ``fold_in``, ``split``, ``bits``, ``uniform``), bit for bit,
and ``fold_uniform``, a fold and a draw in one.

The generator is threefry2x32 in JAX's partitionable mode
(``jax_threefry_partitionable = True``): element ``i`` of a draw of shape S
hashes the 64-bit counter ``i`` (row-major over S), split into its high and
low 32-bit words, under the key, and the two output words are XORed.

A key is an integer tensor ``[..., 2]`` of two uint32 words; a leading batch
``[...]`` gives one key per world, as ``vmap`` over keys does in the
reference. Keys may come in as uint32, int32 (bit pattern) or int64;
``fold_in`` and ``split`` return int64 keys, ``bits`` int64 words.

The public functions take the plain version for CPU tensors and launch the
hand-written kernel ``csrc/threefry.cu`` (``threefry_cuda``) for CUDA keys;
there is no fallback between the two. The plain version is eager torch:
torch has no full uint32 arithmetic, so it holds the words in int64 and
masks them to 32 bits after every add and shift.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from lumixengine_tpu_torch.ops import native

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


def fold_in_plain(key: torch.Tensor, data) -> torch.Tensor:
    """The plain version of ``fold_in``: the hash of the counter (0, data)."""
    key = _words(key)
    # a Python int stays a host scalar: no host-to-device copy per call
    d = int(data) & MASK if isinstance(data, int) else _words(data.to(key.device))
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """The plain version of ``split``: key i is the hash of the counter (0, i)."""
    key = _words(key)
    i = torch.arange(int(num), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, i)
    return torch.stack([y0, y1], dim=-1)


def bits_plain(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """The plain version of ``bits``."""
    key = _words(key)
    shape = tuple(int(s) for s in shape)
    counts = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    y0, y1 = threefry2x32(key[..., 0].reshape(lead), key[..., 1].reshape(lead),
                          counts >> 32, counts & MASK)
    return y0 ^ y1


def uniform_plain(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """The plain version of ``uniform``: the top 23 bits of each word as the
    mantissa of a float in [1, 2), minus 1."""
    b = (bits_plain(key, shape) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0


# ---------------------------------------------------------------------------
# the kernel (csrc/threefry.cu)

_WIDE = {torch.int32: 0, torch.uint32: 0, torch.int64: 1}


def _kernel_operand(name: str, t: torch.Tensor, dev: torch.device, batch: tuple,
                    tail: tuple = ()):
    """An operand of the kernel: its words as the caller holds them, with
    the step (1, or 0 for one entry read by all) of its batch over `batch`;
    an operand broadcasting otherwise is materialised. Raises on another
    device, a dtype the kernel does not read, or a non-contiguous tensor."""
    native.check_operands(dev, **{name: t})
    if t.dtype not in _WIDE:
        raise ValueError(f"threefry: {name} must be uint32, int32 or int64, not {t.dtype}")
    rows = t.numel() // math.prod(tail)
    if rows == 1 or rows == math.prod(batch):
        return t, _WIDE[t.dtype], int(rows != 1)
    return t.expand(batch + tail).contiguous(), _WIDE[t.dtype], 1


def threefry_cuda(key: torch.Tensor, data=None, shape=None, as_uniform: bool = True) -> torch.Tensor:
    """One launch of the Threefry kernel on the key's stream. Without
    `shape`, ``fold_in(key, data)``: int64 keys [batch, 2]. With `shape`, a
    draw under each key of the batch, folded first by `data` unless it is
    None: float32 uniforms (`as_uniform`) or int64 bits [batch, *shape].
    `data` is a Python int or an integer tensor broadcasting against the
    key batch; `batch` is their broadcast."""
    dev = key.device
    if key.shape[-1:] != (2,):
        raise ValueError(f"threefry: a key is [..., 2], not {tuple(key.shape)}")
    tensor_data = isinstance(data, torch.Tensor)
    batch = tuple(torch.broadcast_shapes(key.shape[:-1], data.shape) if tensor_data
                  else key.shape[:-1])
    k, k_wide, k_step = _kernel_operand("key", key, dev, batch, (2,))
    d, d_wide, d_step, scalar = None, 0, 0, 0
    if tensor_data:
        d, d_wide, d_step = _kernel_operand("data", data, dev, batch)
    elif data is not None:
        scalar = int(data) & MASK
    lib = native.library()
    rows = math.prod(batch)
    stream = native.stream_handle(dev)
    d_ptr = d.data_ptr() if d is not None else None
    if shape is None:
        out = torch.empty(batch + (2,), dtype=torch.int64, device=dev)
        rc = lib.lumix_threefry_fold(k.data_ptr(), k_wide, k_step, d_ptr, d_wide, d_step, scalar,
                                     out.data_ptr(), rows, stream)
    else:
        shape = tuple(int(s) for s in shape)
        out = torch.empty(batch + shape, dtype=torch.float32 if as_uniform else torch.int64,
                          device=dev)
        rc = lib.lumix_threefry_draw(k.data_ptr(), k_wide, k_step, d_ptr, d_wide, d_step, scalar,
                                     int(data is not None), int(as_uniform), out.data_ptr(), rows,
                                     math.prod(shape), stream)
    native.check(rc, "lumix_threefry")
    threefry_cuda.launches += 1
    return out


threefry_cuda.launches = 0  # kernel launches, counted where the kernel is launched

# The kernel's bound: each of a hash's 20 rounds needs a rotate (a funnel
# shift) and a xor, which only the SM's integer ALU pipe executes; nvcc
# issues the adds on the FMA pipe (IMAD). A word then needs its xor, and a
# uniform its shift as well (the exponent's or can be an add).
HASH_ALU_OPS = 20 * 2


def threefry_alu_ops(batch: int, n: int, fold: bool = True, as_uniform: bool = True) -> int:
    """Integer ALU-pipe operations of a draw of `n` words under each of
    `batch` keys, each key folded once first when `fold` is set."""
    return batch * (HASH_ALU_OPS * (n + int(fold)) + n * (2 if as_uniform else 1))


def threefry_bytes(batch: int, n: int, key_bytes: int = 16, as_uniform: bool = True) -> int:
    """Bytes such a draw must move: each key read (two int64 words as the
    port holds them, by default) and each word written (float32 or int64)."""
    return batch * (key_bytes + n * (4 if as_uniform else 8))


def _on_card(key: torch.Tensor) -> bool:
    """False for a CPU key (the plain version), True for a CUDA key (the
    kernel); raises for any other device."""
    if key.device.type == "cpu":
        return False
    if key.device.type == "cuda":
        return True
    raise ValueError(f"threefry: unsupported device {key.device}")


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the uint32 value of `data` (a Python int
    or an integer tensor broadcasting against the key batch, e.g. a per-world
    frame counter) under `key` [..., 2] → int64 key [..., 2]."""
    if _on_card(key):
        return threefry_cuda(key, data)
    return fold_in_plain(key, data)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` in partitionable mode: key i is
    ``fold_in(key, i)`` → int64 keys [..., num, 2]."""
    if _on_card(key):
        return threefry_cuda(key.unsqueeze(-2), torch.arange(int(num), device=key.device))
    return split_plain(key, num)


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words as int64) for a key
    batch [..., 2] → [..., *shape]."""
    if _on_card(key):
        return threefry_cuda(key, None, shape, as_uniform=False)
    return bits_plain(key, shape)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 on [0, 1) for a key batch
    [..., 2] → [..., *shape]."""
    if _on_card(key):
        return threefry_cuda(key, None, shape)
    return uniform_plain(key, shape)


def fold_uniform(key: torch.Tensor, data, shape: Sequence[int]) -> torch.Tensor:
    """``uniform(fold_in(key, data), shape)``; one launch on the card."""
    if _on_card(key):
        return threefry_cuda(key, data, shape)
    return uniform_plain(fold_in_plain(key, data), shape)
