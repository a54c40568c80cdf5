"""Shadow cascades (counterpart of ``lumixengine_tpu/renderer/shadows.py``):
4 stable cascades for the directional light — the camera frustum sliced at
practical split distances, each slice's bounding sphere, an ortho light
frustum fit to it, the model instances culled against it as shadow
casters, and the light-space matrices.

Every value is per world: the camera pose and projection carry the batch
axes of the state ([W, ...]), and each reduction (the slice's bounding
radius, the caster count) runs over the corner or instance axis alone. The
light direction is one for the batch. Casters are culled with
``core/geometry.frustum_sphere_visible``, as in the reference (not K1).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from lumixengine_tpu_torch.core import geometry as geom
from lumixengine_tpu_torch.core import math as lm

# practical split scheme: blend of uniform and logarithmic (λ)
SPLIT_LAMBDA = 0.75
NUM_CASCADES = 4
SHADOW_MARGIN = 1e-3   # m: caster decisions this close to a cascade plane may flip


@dataclass
class ShadowView:
    """Per-cascade light-space data and caster visibility."""

    splits: torch.Tensor        # f32 [.., NC+1] slice distances (near → far)
    center: torch.Tensor        # f32 [.., NC, 3] cascade bounding-sphere centres
    radius: torch.Tensor        # f32 [.., NC]
    light_pos: torch.Tensor     # f32 [.., NC, 3] ortho camera position
    extent: torch.Tensor        # f32 [.., NC, 3] ortho half-extents (w, h, depth)
    casters: torch.Tensor       # bool [.., NC, K]
    caster_count: torch.Tensor  # int32 [.., NC]


def cascade_splits(near: torch.Tensor, far: torch.Tensor, n: int = NUM_CASCADES,
                   lam: float = SPLIT_LAMBDA) -> torch.Tensor:
    """Slice distances [.., n+1] mixing uniform and log splits."""
    i = torch.arange(n + 1, dtype=torch.float32, device=near.device) / n
    near, far = near[..., None], far[..., None]
    uni = near + (far - near) * i
    log = near * (far / near) ** i
    return lam * log + (1.0 - lam) * uni


def _frustum_slice_corners(pos, rot, fov_y, aspect, zn, zf) -> torch.Tensor:
    """8 world-space corners of the camera frustum slice [zn, zf]: pos
    [.., 3], rot [.., 4], the scalars [..] → [.., 8, 3]."""
    axes = torch.eye(3, dtype=torch.float32, device=pos.device)
    th = torch.tan(fov_y * 0.5)
    fwd = lm.quat_rotate(rot, -axes[2])
    right = lm.quat_rotate(rot, axes[0])
    up = lm.quat_rotate(rot, axes[1])
    cs = []
    for z in (zn, zf):
        hy = th * z
        hx = hy * aspect
        c = pos + fwd * z[..., None]
        for sx in (-1.0, 1.0):
            for sy in (-1.0, 1.0):
                cs.append(c + right * (sx * hx)[..., None] + up * (sy * hy)[..., None])
    return torch.stack(cs, dim=-2)


def light_rotation(direction: torch.Tensor) -> torch.Tensor:
    """Quaternion [4] orienting -Z along the (normalised) light direction [3]."""
    d = direction.to(torch.float32)
    d = d / torch.clamp_min(torch.sqrt(torch.sum(d * d)), 1e-9)
    z = -d
    axes = torch.eye(3, dtype=torch.float32, device=d.device)
    up0 = torch.where(torch.abs(z[1]) > 0.99, axes[0], axes[1])
    x = lm.cross(up0, z)
    x = x / torch.clamp_min(torch.sqrt(torch.sum(x * x)), 1e-9)
    y = lm.cross(z, x)
    # rotation matrix (columns x, y, z) → quaternion
    t = x[0] + y[1] + z[2]
    qw = torch.sqrt(torch.clamp_min(1.0 + t, 1e-9)) * 0.5
    qx = (y[2] - z[1]) / (4.0 * qw)
    qy = (z[0] - x[2]) / (4.0 * qw)
    qz = (x[1] - y[0]) / (4.0 * qw)
    return lm.quat_normalize(torch.stack([qx, qy, qz, qw]))


@functools.lru_cache(maxsize=None)
def _light_frame(light_dir: tuple, device: str):
    """(unit direction [3], light_rotation [4]) of a constant light, computed
    once on the CPU in float32 and kept on `device`."""
    ldir = torch.tensor(light_dir, dtype=torch.float32)
    ldir = ldir / torch.clamp_min(torch.sqrt(torch.sum(ldir * ldir)), 1e-9)
    return ldir.to(device), light_rotation(ldir).to(device)


def shadow_pass(ws, module, light_dir, cam_slot: int = 0, statics=None,
                z_margin: float = 50.0) -> ShadowView:
    """Fit NUM_CASCADES stable cascades to camera `cam_slot` of every world
    and cull the casters (model instances) per cascade. Stable = the ortho
    frustum fits the slice's bounding sphere."""
    from lumixengine_tpu_torch.renderer import pipeline as pl

    statics = statics or module.statics()
    rs = ws.modules[module.name]
    cam_slot = pl.resolve_cam_slot(statics, cam_slot)
    d = statics.on(ws.world.pos.device)
    cam_e = max(int(statics.cam_slots[cam_slot]), 0)
    pos = ws.world.pos[..., :, cam_e]
    rot = ws.world.rot[..., :, cam_e]
    near = rs.cam_near[..., cam_slot]
    far = torch.clamp_max(rs.cam_far[..., cam_slot], 1024.0)
    fov = rs.cam_fov[..., cam_slot]
    aspect = rs.cam_aspect[..., cam_slot]

    splits = cascade_splits(near, far)
    ldir, lrot = _light_frame(tuple(float(x) for x in light_dir), str(pos.device))

    ipos = ws.world.pos.index_select(-1, d.mi_index)            # [.., 3, K]
    iscale = ws.world.scale.index_select(-1, d.mi_index)
    obj_r = d.radius * torch.amax(torch.abs(iscale), dim=-2)
    alive = ws.alive.index_select(-1, d.mi_index) & d.mi_mask

    # the NUM_CASCADES slices at once, on an axis before the corner axis
    corners = _frustum_slice_corners(pos[..., None, :], rot[..., None, :], fov[..., None],
                                     aspect[..., None], splits[..., :-1], splits[..., 1:])
    center = torch.mean(corners, dim=-2)                                       # [.., NC, 3]
    radius = torch.amax(torch.linalg.vector_norm(corners - center[..., None, :], dim=-1), dim=-1)
    light_pos = center - ldir * (radius + z_margin)[..., None]
    fr = geom.ortho_frustum(light_pos, lrot, 2.0 * radius, 2.0 * radius, 0.0,
                            2.0 * radius + z_margin)
    casters = (geom.frustum_sphere_visible(fr, ipos[..., None, :, :], obj_r[..., None, :])
               & alive[..., None, :])
    return ShadowView(splits=splits, center=center, radius=radius, light_pos=light_pos,
                      extent=torch.stack([radius, radius, radius + z_margin], dim=-1),
                      casters=casters, caster_count=torch.sum(casters, dim=-1, dtype=torch.int32))


def caster_margins(ws, module, sv: ShadowView, light_dir, statics=None,
                   z_margin: float = 50.0) -> torch.Tensor:
    """How far each caster decision of `sv` sits from its threshold, in
    float64 [.., NC, K]: the least plane distance of the instance's sphere
    in the cascade's ortho frustum. Two float32 implementations may
    disagree only where it is under SHADOW_MARGIN."""
    statics = statics or module.statics()
    d = statics.on(ws.world.pos.device)
    c = ws.world.pos.index_select(-1, d.mi_index).double()
    r = (d.radius * torch.amax(torch.abs(ws.world.scale.index_select(-1, d.mi_index)),
                               dim=-2)).double()
    _ldir, lrot = _light_frame(tuple(float(x) for x in light_dir), str(c.device))
    fr = geom.ortho_frustum(sv.light_pos, lrot, 2.0 * sv.radius, 2.0 * sv.radius, 0.0,
                            2.0 * sv.radius + z_margin)
    dist = sum(p.double()[..., :6, None] * c[..., None, k, None, :]
               for k, p in enumerate((fr.xs, fr.ys, fr.zs))) + fr.ds.double()[..., :6, None]
    return dist.amin(dim=-2) + r[..., None, :]


def cascade_matrices(sv: ShadowView, light_dir) -> torch.Tensor:
    """Light view-projection matrices [.., NC, 4, 4] (row-vector convention):
    world → light space, then x/ex.x, y/ex.y and z over [0, 2 ex.z] → [0, 1]."""
    dev = sv.light_pos.device
    _ldir, lrot = _light_frame(tuple(float(x) for x in light_dir), str(dev))
    inv = lm.quat_conjugate(lrot)
    axes = torch.stack([lm.quat_rotate(inv, e) for e in torch.eye(3, device=dev)])  # [3, 3]
    p = sv.light_pos                                                 # [.., NC, 3]
    batch = p.shape[:-1]
    view = torch.eye(4, dtype=torch.float32, device=dev).expand(batch + (4, 4)).clone()
    view[..., :3, :3] = axes.T
    view[..., 3, :3] = -torch.stack([torch.sum(p * axes[j], dim=-1) for j in range(3)], dim=-1)
    ex = sv.extent
    one = torch.ones(batch, dtype=torch.float32, device=dev)
    proj = torch.diag_embed(torch.stack([1.0 / ex[..., 0], 1.0 / ex[..., 1], -0.5 / ex[..., 2],
                                         one], dim=-1))
    return view @ proj
