"""Frustum planes, the sphere and AABB tests, and the ray and overlap
primitives (counterpart of ``lumixengine_tpu/core/geometry.py``).

A Frustum holds 8 planes as SoA rows xs/ys/zs/ds ``[..., 8]``: 6 real planes
with inward normals and 2 always-pass padding planes ``(0, 0, 0, 1e30)``.
Camera parameters may carry the batch shape of the camera pose (one camera
per world), so every scalar is broadcast against the pose's batch axes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from lumixengine_tpu_torch.core import math as lm

NUM_PLANES = 8  # 6 used + 2 padding, as the reference's Frustum


@dataclass
class Frustum:
    xs: torch.Tensor  # [..., 8]
    ys: torch.Tensor
    zs: torch.Tensor
    ds: torch.Tensor

    @property
    def planes(self) -> torch.Tensor:
        """[..., 8, 4] dense view."""
        return torch.stack([self.xs, self.ys, self.zs, self.ds], dim=-1)


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """Camera scalar → tensor of the pose's batch shape, with a trailing
    axis to broadcast against [..., 3] vectors."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device).unsqueeze(-1)


def _basis(position, rotation):
    position = torch.as_tensor(position, dtype=torch.float32)
    rotation = torch.as_tensor(rotation, dtype=torch.float32, device=position.device)
    axes = torch.eye(3, dtype=torch.float32, device=position.device)
    fwd = lm.quat_rotate(rotation, -axes[2])
    up = lm.quat_rotate(rotation, axes[1])
    right = lm.quat_rotate(rotation, axes[0])
    return position, fwd, up, right


def _pack_frustum(normals, ds) -> Frustum:
    n = torch.stack(normals, dim=-2)  # [..., 6, 3]
    d = torch.stack(ds, dim=-1)       # [..., 6]
    pad_n = torch.zeros(n.shape[:-2] + (2, 3), dtype=n.dtype, device=n.device)
    pad_d = torch.full(d.shape[:-1] + (2,), 1e30, dtype=d.dtype, device=d.device)
    n = torch.cat([n, pad_n], dim=-2)
    d = torch.cat([d, pad_d], dim=-1)
    return Frustum(xs=n[..., 0], ys=n[..., 1], zs=n[..., 2], ds=d)


def perspective_frustum(position, rotation, fov_y, aspect, near, far) -> Frustum:
    """View frustum of a camera looking along its local -Z (+Y up), vertical
    fov in radians. Built corner-first, planes oriented inward through the
    frustum centroid, in the reference's order of operations."""
    position, fwd, up, right = _basis(position, rotation)
    tan_half = torch.tan(torch.as_tensor(fov_y, dtype=torch.float32,
                                         device=position.device) * 0.5)
    near = torch.as_tensor(near, dtype=torch.float32, device=position.device)
    far = torch.as_tensor(far, dtype=torch.float32, device=position.device)
    nh = tan_half * near
    nw = nh * aspect
    fh = tan_half * far
    fw = fh * aspect
    nh, nw, fh, fw = (_scalar(x, position) for x in (nh, nw, fh, fw))

    nc = position + fwd * _scalar(near, position)
    fc = position + fwd * _scalar(far, position)
    ntl = nc + up * nh - right * nw
    ntr = nc + up * nh + right * nw
    nbl = nc - up * nh - right * nw
    nbr = nc - up * nh + right * nw
    ftl = fc + up * fh - right * fw
    ftr = fc + up * fh + right * fw
    fbl = fc - up * fh - right * fw
    fbr = fc - up * fh + right * fw
    centroid = (ntl + ntr + nbl + nbr + ftl + ftr + fbl + fbr) / 8.0

    def inward(a, b, c):
        n = lm.normalize(lm.cross(b - a, c - a))
        d = -lm.dot(n, a)
        side = lm.dot(n, centroid) + d
        flip = torch.where(side < 0.0, -1.0, 1.0)
        return n * flip.unsqueeze(-1), d * flip

    planes = [
        inward(ntl, ntr, nbr),  # near
        inward(ftl, fbr, ftr),  # far
        inward(ntl, nbl, fbl),  # left
        inward(ntr, fbr, nbr),  # right
        inward(ntl, ftl, ftr),  # top
        inward(nbl, nbr, fbr),  # bottom
    ]
    return _pack_frustum([p[0] for p in planes], [p[1] for p in planes])


def ortho_frustum(position, rotation, width, height, near, far) -> Frustum:
    """Orthographic frustum (width/height are full extents)."""
    position, fwd, up, right = _basis(position, rotation)
    hw = _scalar(torch.as_tensor(width, dtype=torch.float32, device=position.device) * 0.5,
                 position)
    hh = _scalar(torch.as_tensor(height, dtype=torch.float32, device=position.device) * 0.5,
                 position)
    normals = [fwd, -fwd, right, -right, -up, up]
    points = [
        position + fwd * _scalar(near, position),
        position + fwd * _scalar(far, position),
        position - right * hw,
        position + right * hw,
        position + up * hh,
        position - up * hh,
    ]
    ds = [-lm.dot(n, p) for n, p in zip(normals, points)]
    return _pack_frustum(normals, ds)


def frustum_sphere_visible(frustum: Frustum, centers, radii) -> torch.Tensor:
    """Sphere-vs-frustum over all 8 planes: visible iff dot(n, c) + d >= -r
    for every plane. centers [..., 3, N], radii [..., N] → bool [..., N]."""
    cx, cy, cz = lm.unstack(centers, -2)
    dist = (
        frustum.xs[..., :, None] * cx[..., None, :]
        + frustum.ys[..., :, None] * cy[..., None, :]
        + frustum.zs[..., :, None] * cz[..., None, :]
        + frustum.ds[..., :, None]
    )
    return torch.all(dist >= -radii[..., None, :], dim=-2)


def frustum_contains_aabb(frustum: Frustum, mins, maxs) -> torch.Tensor:
    """Conservative AABB test by the p-vertex: per plane the corner farthest
    along the normal; outside if even that corner is. mins/maxs
    [..., 3, N] → bool [..., N]."""
    nx = frustum.xs[..., :, None]
    ny = frustum.ys[..., :, None]
    nz = frustum.zs[..., :, None]
    mnx, mny, mnz = (m[..., None, :] for m in lm.unstack(mins, -2))
    mxx, mxy, mxz = (m[..., None, :] for m in lm.unstack(maxs, -2))
    px = torch.where(nx >= 0, mxx, mnx)
    py = torch.where(ny >= 0, mxy, mny)
    pz = torch.where(nz >= 0, mxz, mnz)
    dist = px * nx + py * ny + pz * nz + frustum.ds[..., :, None]
    return torch.all(dist >= 0.0, dim=-2)


def sphere_sphere_overlap(ca, ra, cb, rb):
    return lm.squared_length(cb - ca) <= (ra + rb) ** 2


def aabb_overlap(min_a, max_a, min_b, max_b):
    return torch.all((min_a <= max_b) & (min_b <= max_a), dim=-1)


def ray_sphere(origin, direction, center, radius):
    """(hit bool, t); direction must be normalized; t is inf on a miss."""
    oc = origin - center
    b = lm.dot(oc, direction)
    c = lm.squared_length(oc) - radius * radius
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
    hit = (disc >= 0.0) & (t >= 0.0)
    return hit, torch.where(hit, t, torch.inf)


def ray_aabb(origin, direction, mins, maxs, eps: float = 1e-12):
    """Slab test: (hit bool, t_enter); t is inf on a miss."""
    small = torch.where(direction >= 0, eps, -eps)
    inv = 1.0 / torch.where(torch.abs(direction) < eps, small, direction)
    t0 = (mins - origin) * inv
    t1 = (maxs - origin) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = tmax >= torch.clamp_min(tmin, 0.0)
    return hit, torch.where(hit, torch.clamp_min(tmin, 0.0), torch.inf)


def ray_plane(origin, direction, normal, d):
    """(hit bool, t) against the plane dot(n, p) + d = 0; t is inf on a miss."""
    denom = lm.dot(direction, normal)
    near0 = torch.abs(denom) < 1e-12
    t = -(lm.dot(origin, normal) + d) / torch.where(near0, 1e-12, denom)
    hit = ~near0 & (t >= 0.0)
    return hit, torch.where(hit, t, torch.inf)
