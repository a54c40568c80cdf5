"""Clustered light assignment (counterpart of
``lumixengine_tpu/renderer/clusters.py``): the view frustum binned into x/y
tiles and exponential z slices, each cluster holding the point lights whose
range sphere touches its view-space AABB.

The cluster × light test is packed into 32-bit bitset words [.., C, L/32],
computed one 32-light word group at a time (a Python loop over at most
L/32 groups), so the live set is a few [W, C, 32] slabs and never a
[W, C, L] grid; then MAX_LIGHTS_PER_CLUSTER find-first-set rounds turn the
words into each cluster's lowest light slots. The reference's words are
uint32; torch's uint32 is a storage type with few kernels, so the port
carries each word's value in int64, with a SWAR popcount (torch has none).
Everything is per world: the camera's near/far/fov/aspect are [.., cam]
columns, so each world has its own cluster bounds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from lumixengine_tpu_torch.core import math as lm

GRID = (16, 8, 24)          # x tiles, y tiles, z slices
MAX_LIGHTS_PER_CLUSTER = 8
WORD = 32                   # lights per bitset word
CLUSTER_D2_EPS = 1e-2       # m²: cluster-light tests this close to range² may flip


@dataclass
class ClusterLights:
    lights: torch.Tensor    # int32 [.., C, MAX] light slots, -1 padded
    count: torch.Tensor     # int32 [.., C]
    overflow: torch.Tensor  # int32 [..] lights dropped by the per-cluster budget


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of each int64 value (SWAR)."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _cluster_bounds(near, far, fov_y, aspect, grid: Tuple[int, int, int]):
    """View-space AABBs of every cluster of each world's camera → (mins
    [.., C, 3], maxs [.., C, 3]), C = nx·ny·nz in (z, y, x) order. The camera
    looks down -Z; z slices are exponential; each slice's x/y extents are
    taken at its near and far planes (conservative)."""
    nx, ny, nz = grid
    dev = near.device
    i = torch.arange(nz + 1, dtype=torch.float32, device=dev) / nz
    zs = near[..., None] * (far / near)[..., None] ** i          # [.., nz+1]
    th = torch.tan(fov_y * 0.5)[..., None]
    aspect = aspect[..., None]
    z0, z1 = zs[..., :-1], zs[..., 1:]
    hy1 = th * z1
    hx1 = hy1 * aspect

    xi = torch.arange(nx, dtype=torch.float32, device=dev)
    yi = torch.arange(ny, dtype=torch.float32, device=dev)
    ex0, ex1 = 2.0 * xi / nx - 1.0, 2.0 * (xi + 1.0) / nx - 1.0   # tile edges in [-1, 1]
    ey0, ey1 = 2.0 * yi / ny - 1.0, 2.0 * (yi + 1.0) / ny - 1.0

    def b(a, axis):   # [.., n] → broadcastable against [.., nz, ny, nx]
        sh = [1, 1, 1]
        sh[axis] = a.shape[-1]
        return a.reshape(a.shape[:-1] + tuple(sh))

    x0 = torch.minimum(b(ex0, 2) * b(hx1, 0), b(ex0, 2) * b(th * z0 * aspect, 0))
    x1 = torch.maximum(b(ex1, 2) * b(hx1, 0), b(ex1, 2) * b(th * z0 * aspect, 0))
    y0 = torch.minimum(b(ey0, 1) * b(hy1, 0), b(ey0, 1) * b(th * z0, 0))
    y1 = torch.maximum(b(ey1, 1) * b(hy1, 0), b(ey1, 1) * b(th * z0, 0))
    z_min = -b(z1, 0)                                  # view space: the far side
    z_max = -b(z0, 0)
    shape = torch.broadcast_shapes(x0.shape, y0.shape, z_min.shape)
    mins = torch.stack([t.expand(shape) for t in (x0, y0, z_min)], dim=-1)
    maxs = torch.stack([t.expand(shape) for t in (x1, y1, z_max)], dim=-1)
    return mins.reshape(shape[:-3] + (-1, 3)), maxs.reshape(shape[:-3] + (-1, 3))


def cluster_inputs(ws, module, cam_slot: int = 0, statics=None,
                   grid: Tuple[int, int, int] = GRID):
    """The operands of the assignment for camera `cam_slot` of every world:
    (view-space light positions [.., L, 3], ranges [.., L], mask [L],
    cluster mins [.., C, 3], maxs [.., C, 3])."""
    from lumixengine_tpu_torch.renderer.pipeline import resolve_cam_slot

    statics = statics or module.statics()
    rs = ws.modules[module.name]
    cam_slot = resolve_cam_slot(statics, cam_slot)
    d = statics.on(ws.world.pos.device)
    cam_e = max(int(statics.cam_slots[cam_slot]), 0)
    cpos = ws.world.pos[..., :, cam_e]
    crot = ws.world.rot[..., :, cam_e]
    mins, maxs = _cluster_bounds(rs.cam_near[..., cam_slot], rs.cam_far[..., cam_slot],
                                 rs.cam_fov[..., cam_slot], rs.cam_aspect[..., cam_slot], grid)
    lw = ws.world.pos.index_select(-1, d.pl_index)                 # [.., 3, L] world
    inv = lm.quat_conjugate(crot)
    lv = lm.quat_rotate(inv[..., :, None], lw - cpos[..., :, None], axis=-2)
    return lv.transpose(-1, -2), rs.pl_range, d.pl_mask, mins, maxs


def fill_clusters(ws, module, cam_slot: int = 0, statics=None,
                  grid: Tuple[int, int, int] = GRID,
                  max_per_cluster: int = MAX_LIGHTS_PER_CLUSTER) -> ClusterLights:
    """Assign every point light to the clusters its range sphere touches."""
    return _assign_bitset(*cluster_inputs(ws, module, cam_slot, statics, grid), max_per_cluster)


def _pad_to_words(lv, rng, mask):
    """Pad the light axis to a whole number of words: (lv, rng, mask, nw)."""
    n = lv.shape[-2]
    nw = -(-n // WORD)
    pad = nw * WORD - n
    if pad:
        lv = torch.nn.functional.pad(lv, (0, 0, 0, pad))
        rng = torch.nn.functional.pad(rng, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return lv, rng, mask, nw


def _pack(touch: torch.Tensor) -> torch.Tensor:
    """bool [.., C, n·32] → words int64 [.., C, n] (bit j = light 32·w + j)."""
    bits = touch.reshape(touch.shape[:-1] + (-1, WORD)).to(torch.int64)
    shift = torch.arange(WORD, dtype=torch.int64, device=touch.device)
    return torch.sum(bits << shift, dim=-1)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """words int64 [.., C, n] → bool [.., C, n·32], the inverse of `_pack`."""
    shift = torch.arange(WORD, dtype=torch.int64, device=words.device)
    return ((words[..., None] >> shift) & 1).bool().flatten(-2)


def touch_margins(lv, rng, mask, mins, maxs) -> torch.Tensor:
    """|squared distance − range²| of every (cluster, light) test in float64
    [.., C, L·] (lights padded to whole words; masked lights +inf). Two
    float32 implementations may disagree only where it is under
    CLUSTER_D2_EPS."""
    lv, rng, mask, _nw = _pad_to_words(lv, rng, mask)
    p = lv.double()[..., None, :, :]
    diff = torch.clamp(p, mins.double()[..., :, None, :], maxs.double()[..., :, None, :]) - p
    m = (torch.sum(diff * diff, dim=-1) - (rng.double() ** 2)[..., None, :]).abs()
    return torch.where(mask[..., None, :], m, float("inf"))


def _touch_words_dense(lv, rng, mask, mins, maxs):
    """The oracle: the whole [.., C, L] test at once, then packed. It
    materialises [W, C, L, 3] floats (9.7 GB at W=1024, C=3072, L=256), so
    it serves the tests only."""
    lv, rng, mask, _nw = _pad_to_words(lv, rng, mask)
    p = lv[..., None, :, :]                                           # [.., 1, L, 3]
    c = torch.clamp(p, mins[..., :, None, :], maxs[..., :, None, :])  # [.., C, L, 3]
    diff = c - p
    d2 = torch.sum(diff * diff, dim=-1)
    touch = (d2 <= (rng * rng)[..., None, :]) & mask[..., None, :]
    return _pack(touch)


def _touch_words(lv, rng, mask, mins, maxs):
    """Sphere-vs-cluster-AABB tests packed into words [.., C, ceil(L/32)],
    one 32-light word group at a time, the squared distance accumulated
    axis by axis, so each group holds only [.., C, 32] slabs. Bit for bit
    equal to `_touch_words_dense`."""
    lv, rng, mask, nw = _pad_to_words(lv, rng, mask)
    r2 = rng * rng
    words = []
    for g in range(nw):
        sl = slice(g * WORD, (g + 1) * WORD)
        d2 = None
        for a in range(3):                               # per axis: [.., C, 32]
            la = lv[..., None, sl, a]
            diff = torch.clamp(la, mins[..., :, None, a], maxs[..., :, None, a]) - la
            d2 = diff * diff if d2 is None else d2 + diff * diff
        touch = (d2 <= r2[..., None, sl]) & mask[..., None, sl]
        words.append(_pack(touch))
    return torch.cat(words, dim=-1)


def _assign_bitset(lv, rng, mask, mins, maxs, max_per_cluster):
    words = _touch_words(lv, rng, mask, mins, maxs)
    nw = words.shape[-1]
    count = torch.sum(popcount32(words), dim=-1).to(torch.int32)

    # the lowest max_per_cluster set bits of each cluster: k find-first-set
    # rounds over [.., C, nw], never a [.., C, L] integer array
    lanes = torch.arange(nw, dtype=torch.int64, device=words.device)
    cols = []
    for _ in range(max_per_cluster):
        nz = words != 0
        has = torch.any(nz, dim=-1)
        first_w = torch.argmax(nz.to(torch.int32), dim=-1)               # the first nonzero word
        sel = lanes == first_w[..., None]
        w = torch.sum(torch.where(sel, words, 0), dim=-1)
        lsb = w & -w
        bit = popcount32(lsb - 1)
        cols.append(torch.where(has, first_w * WORD + bit, -1))
        words = words - torch.where(sel, lsb[..., None], 0)
    lights = torch.stack(cols, dim=-1).to(torch.int32)
    overflow = torch.sum(torch.clamp_min(count - max_per_cluster, 0), dim=-1, dtype=torch.int32)
    return ClusterLights(lights=lights, count=torch.clamp_max(count, max_per_cluster),
                         overflow=overflow)
