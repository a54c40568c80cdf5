"""Terrain heightmaps (counterpart of ``lumixengine_tpu/renderer/terrain.py``):
the registry of heightmaps, their bank on a device, bilinear height and
normal sampling (read by the heightfield contacts, the character
controllers and the render ``terrain`` component), the seeded grass
scatter and the chunk LOD pick.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from lumixengine_tpu_torch.core import random as prng


@dataclass
class TerrainBank:
    """Stacked padded heightmaps on one device; leading axis = terrain id."""

    heights: torch.Tensor   # f32 [T, H, W]
    inv_xz: torch.Tensor    # f32 [T] 1 / xz cell size
    y_scale: torch.Tensor   # f32 [T]
    size: torch.Tensor      # int32 [T, 2] (h, w) used


def sample_height(bank: TerrainBank, tid: int, x, z):
    """Bilinear heightmap sample in terrain-local space → y [..., K] for
    x/z [..., K] local coordinates."""
    hm = bank.heights[tid]
    inv, ys = bank.inv_xz[tid], bank.y_scale[tid]
    h, w = bank.size[tid, 0].to(torch.float32), bank.size[tid, 1].to(torch.float32)
    gx = torch.minimum(torch.clamp_min(x * inv, 0.0), w - 1.001)
    gz = torch.minimum(torch.clamp_min(z * inv, 0.0), h - 1.001)
    x0 = torch.floor(gx).to(torch.int64)
    z0 = torch.floor(gz).to(torch.int64)
    fx, fz = gx - x0, gz - z0
    flat, stride = hm.reshape(-1), hm.shape[-1]

    def at(dz, dx):
        return flat[(z0 + dz) * stride + (x0 + dx)]

    return ((at(0, 0) * (1 - fx) + at(0, 1) * fx) * (1 - fz)
            + (at(1, 0) * (1 - fx) + at(1, 1) * fx) * fz) * ys


def sample_normal(bank: TerrainBank, tid: int, x, z, eps: float = 0.5):
    """Central-difference surface normal [..., 3, K] (y up)."""
    hl = sample_height(bank, tid, x - eps, z)
    hr = sample_height(bank, tid, x + eps, z)
    hd = sample_height(bank, tid, x, z - eps)
    hu = sample_height(bank, tid, x, z + eps)
    n = torch.stack([hl - hr, torch.full_like(hl, 2.0 * eps), hd - hu], dim=-2)
    return n * torch.rsqrt(torch.clamp_min(torch.sum(n * n, dim=-2, keepdim=True), 1e-12))


def scatter_grass(bank: TerrainBank, tid: int, density: float, extent_xz, key,
                  max_instances: int = 4096, max_slope_y: float = 0.7):
    """Grass instance transforms: a seeded uniform scatter over the extent,
    snapped to the heightmap, masked by slope and by the density's count →
    (pos [3, N], yaw [N], mask [N]). `key` is a threefry key; the draws are
    the reference's (``jax.random.split(key, 3)``, then ``uniform``) bit for
    bit."""
    kx, kz, ka = prng.split(key, 3)
    n = max_instances
    x = prng.uniform(kx, (n,)) * extent_xz[0]
    z = prng.uniform(kz, (n,)) * extent_xz[1]
    y = sample_height(bank, tid, x, z)
    nrm = sample_normal(bank, tid, x, z)
    yaw = prng.uniform(ka, (n,)) * (2 * np.pi)
    wanted = torch.arange(n, device=x.device) < int(np.int32(density * extent_xz[0] * extent_xz[1]))
    mask = (nrm[1] > max_slope_y) & wanted
    return torch.stack([x, y, z], dim=-2), yaw, mask


def terrain_lod_levels(dist2: torch.Tensor, lod_distances) -> torch.Tensor:
    """Chunk LOD by camera distance, the model LODs' rule: the number of
    switch distances passed. dist2 [..., K], lod_distances [L] or [..., L, K]."""
    lod = torch.as_tensor(lod_distances, dtype=dist2.dtype, device=dist2.device)
    return torch.sum(dist2[..., None, :] > lod[..., :, None], dim=-2)


class TerrainRegistry:
    """Host terrain store; `bank(device)` bakes it once a device."""

    def __init__(self):
        self.terrains: List[dict] = []
        self._banks: Dict[str, TerrainBank] = {}

    def add(self, heights: np.ndarray, xz_scale: float = 1.0, y_scale: float = 1.0,
            grass_types: Optional[List[dict]] = None) -> int:
        self.terrains.append({
            "heights": np.asarray(heights, np.float32),
            "xz_scale": float(xz_scale),
            "y_scale": float(y_scale),
            "grass_types": grass_types or [],
        })
        self._banks = {}
        return len(self.terrains) - 1

    def get(self, tid: int) -> dict:
        return self.terrains[tid]

    def bank(self, device) -> TerrainBank:
        key = str(torch.device(device))
        if key not in self._banks:
            t = max(len(self.terrains), 1)
            mh = max([2] + [tr["heights"].shape[0] for tr in self.terrains])
            mw = max([2] + [tr["heights"].shape[1] for tr in self.terrains])
            hs = np.zeros((t, mh, mw), np.float32)
            inv = np.ones(t, np.float32)
            ys = np.ones(t, np.float32)
            size = np.full((t, 2), 2, np.int32)
            for i, tr in enumerate(self.terrains):
                h, w = tr["heights"].shape
                hs[i, :h, :w] = tr["heights"]
                inv[i] = 1.0 / tr["xz_scale"]
                ys[i] = tr["y_scale"]
                size[i] = (h, w)
            self._banks[key] = TerrainBank(*(torch.as_tensor(a, device=device)
                                             for a in (hs, inv, ys, size)))
        return self._banks[key]
