"""Gizmo manipulation math (counterpart of
``lumixengine_tpu/editor/gizmo.py``; ≙ reference src/editor/gizmo.{h,cpp}).

The reference gizmo is immediate-mode: each frame it picks the hovered handle
from the camera ray, and while dragging converts ray motion into a transform
delta (translate along axis/plane, rotate about axis, scale along axis), with
optional step snapping and local/global coordinate systems. The UI drawing is
out of scope headless; THIS math — pick + drag resolution — is the
load-bearing part and is implemented exactly, as pure host numpy.

Conventions: right-handed, rays as (origin, unit dir). A gizmo sits at a
Transform (pos [3], rot quat [4] xyzw, scale). In GLOBAL mode handles align
to world axes; in LOCAL mode to the object's rotated axes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional, Tuple

import numpy as np

from lumixengine_tpu_torch.core import host_math as hm


class Mode(IntEnum):
    TRANSLATE = 0
    ROTATE = 1
    SCALE = 2


class CoordSystem(IntEnum):
    GLOBAL = 0
    LOCAL = 1


class Handle(IntEnum):
    NONE = -1
    X = 0
    Y = 1
    Z = 2
    XY = 3
    XZ = 4
    YZ = 5
    XYZ = 6      # uniform scale / screen-space translate


@dataclass
class Config:
    """≙ Gizmo::Config."""

    mode: Mode = Mode.TRANSLATE
    coord_system: CoordSystem = CoordSystem.GLOBAL
    is_step: bool = False
    steps: Tuple[float, float, float] = (1.0, np.pi / 8, 1.0)  # move, rot, scale
    anisotropic_scale: bool = False
    scale: float = 1.0   # gizmo display scale (influences pick radii)


@dataclass
class DragState:
    handle: Handle = Handle.NONE
    start_point: np.ndarray = field(default_factory=lambda: np.zeros(3))
    start_pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    start_rot: np.ndarray = field(default_factory=lambda: np.asarray([0, 0, 0, 1.0]))
    start_scale: np.ndarray = field(default_factory=lambda: np.ones(3))
    axis: np.ndarray = field(default_factory=lambda: np.asarray([1.0, 0, 0]))
    plane_normal: np.ndarray = field(default_factory=lambda: np.zeros(3))


def _axes(rot, coord_system: CoordSystem) -> np.ndarray:
    """Handle axes [3,3] (rows x,y,z) in world space."""
    if coord_system == CoordSystem.LOCAL:
        return np.stack([hm.quat_rotate(np.asarray(rot, np.float32), v)
                         for v in np.eye(3, dtype=np.float32)])
    return np.eye(3, dtype=np.float32)


def ray_point_axis(origin, direction, pos, axis):
    """Closest points between a ray and an axis line through pos → (t_ray,
    s_axis, distance)."""
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    p = np.asarray(pos, np.float64)
    a = np.asarray(axis, np.float64)
    w = o - p
    b = float(d @ a)
    denom = 1.0 - b * b
    if abs(denom) < 1e-9:   # parallel
        t = 0.0
        s = float(w @ a)
    else:
        t = float((b * (w @ a) - (w @ d)) / denom)
        s = float(((w @ a) - b * (w @ d)) / denom)
    t = max(t, 0.0)
    pr = o + d * t
    pa = p + a * s
    return t, s, float(np.linalg.norm(pr - pa))


def ray_plane(origin, direction, pos, normal) -> Optional[np.ndarray]:
    """Ray ∩ plane(pos, normal) → point or None."""
    dn = float(np.dot(direction, normal))
    if abs(dn) < 1e-9:
        return None
    t = float(np.dot(np.asarray(pos) - np.asarray(origin), normal)) / dn
    if t < 0:
        return None
    return np.asarray(origin) + np.asarray(direction) * t


def pick(cfg: Config, pos, rot, ray_origin, ray_dir,
         size: float = 1.0) -> Handle:
    """Hovered handle for the current mode (≙ gizmo.cpp collide/isHit).
    `size` is the gizmo's world-space handle length."""
    pos = np.asarray(pos, np.float64)
    axes = _axes(rot, cfg.coord_system) * 1.0
    r_axis = 0.12 * size * cfg.scale
    if cfg.mode in (Mode.TRANSLATE, Mode.SCALE):
        # plane handles first (quarter-quad between axis pairs)
        if cfg.mode == Mode.TRANSLATE:
            for h, (i, j) in ((Handle.XY, (0, 1)), (Handle.XZ, (0, 2)),
                              (Handle.YZ, (1, 2))):
                n = np.cross(axes[i], axes[j])
                hit = ray_plane(ray_origin, ray_dir, pos, n)
                if hit is None:
                    continue
                li = float((hit - pos) @ axes[i])
                lj = float((hit - pos) @ axes[j])
                if 0.2 * size <= li <= 0.6 * size and 0.2 * size <= lj <= 0.6 * size:
                    return h
        best, best_d = Handle.NONE, r_axis
        for h, a in ((Handle.X, axes[0]), (Handle.Y, axes[1]), (Handle.Z, axes[2])):
            _, s, d = ray_point_axis(ray_origin, ray_dir, pos, a)
            if 0.0 <= s <= size and d < best_d:
                best, best_d = h, d
        if best == Handle.NONE and cfg.mode == Mode.SCALE:
            # center cube: uniform scale
            _, _, d = ray_point_axis(ray_origin, ray_dir, pos,
                                     np.asarray([0.0, 1.0, 0.0]))
            if float(np.linalg.norm(
                    np.asarray(ray_origin) - pos)) >= 0 and d < 0.2 * size:
                return Handle.XYZ
        return best
    # ROTATE: pick the ring whose plane-hit lands near radius `size`
    best, best_err = Handle.NONE, 0.15 * size
    for h, n in ((Handle.X, axes[0]), (Handle.Y, axes[1]), (Handle.Z, axes[2])):
        hit = ray_plane(ray_origin, ray_dir, pos, n)
        if hit is None:
            continue
        err = abs(float(np.linalg.norm(hit - pos)) - size)
        if err < best_err:
            best, best_err = h, err
    return best


def start_drag(cfg: Config, handle: Handle, pos, rot, scale,
               ray_origin, ray_dir) -> DragState:
    """Capture the drag reference (≙ gizmo.cpp startDrag)."""
    pos = np.asarray(pos, np.float64)
    axes = _axes(rot, cfg.coord_system)
    ds = DragState(handle=handle,
                   start_pos=np.asarray(pos, np.float32).copy(),
                   start_rot=np.asarray(rot, np.float32).copy(),
                   start_scale=np.asarray(scale, np.float32).copy())
    if handle in (Handle.X, Handle.Y, Handle.Z):
        ds.axis = axes[int(handle)].astype(np.float32)
        if cfg.mode == Mode.ROTATE:
            ds.plane_normal = ds.axis
            hit = ray_plane(ray_origin, ray_dir, pos, ds.plane_normal)
            ds.start_point = (np.asarray(hit, np.float32)
                              if hit is not None else pos.astype(np.float32))
        else:
            _, s, _ = ray_point_axis(ray_origin, ray_dir, pos, ds.axis)
            ds.start_point = (pos + ds.axis * s).astype(np.float32)
    elif handle in (Handle.XY, Handle.XZ, Handle.YZ):
        i, j = {Handle.XY: (0, 1), Handle.XZ: (0, 2), Handle.YZ: (1, 2)}[handle]
        ds.plane_normal = np.cross(axes[i], axes[j]).astype(np.float32)
        hit = ray_plane(ray_origin, ray_dir, pos, ds.plane_normal)
        ds.start_point = (np.asarray(hit, np.float32)
                          if hit is not None else pos.astype(np.float32))
    else:  # XYZ
        ds.axis = np.asarray(ray_dir, np.float32)
        _, s, _ = ray_point_axis(ray_origin, ray_dir, pos,
                                 np.asarray([0.0, 1.0, 0.0]))
        ds.start_point = pos.astype(np.float32)
    return ds


def _snap(v: float, step: float) -> float:
    return round(v / step) * step if step > 0 else v


def drag(cfg: Config, ds: DragState, ray_origin, ray_dir
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resolve the drag to (pos, rot, scale) (≙ gizmo.cpp translate/rotate/
    scale drag paths, including step snapping)."""
    pos0 = np.asarray(ds.start_pos, np.float64)
    if cfg.mode == Mode.TRANSLATE:
        if ds.handle in (Handle.X, Handle.Y, Handle.Z):
            _, s, _ = ray_point_axis(ray_origin, ray_dir, pos0, ds.axis)
            cur = pos0 + np.asarray(ds.axis, np.float64) * s
            delta = float((cur - ds.start_point) @ ds.axis)
            if cfg.is_step:
                delta = _snap(delta, cfg.steps[0])
            new_pos = pos0 + ds.axis * delta
        else:
            hit = ray_plane(ray_origin, ray_dir, pos0, ds.plane_normal)
            if hit is None:
                return ds.start_pos, ds.start_rot, ds.start_scale
            delta_v = hit - ds.start_point
            if cfg.is_step:
                delta_v = np.asarray([_snap(float(x), cfg.steps[0]) for x in delta_v])
            new_pos = pos0 + delta_v
        return new_pos.astype(np.float32), ds.start_rot, ds.start_scale

    if cfg.mode == Mode.ROTATE:
        hit = ray_plane(ray_origin, ray_dir, pos0, ds.plane_normal)
        if hit is None:
            return ds.start_pos, ds.start_rot, ds.start_scale
        v0 = np.asarray(ds.start_point, np.float64) - pos0
        v1 = np.asarray(hit, np.float64) - pos0
        n0 = np.linalg.norm(v0)
        n1 = np.linalg.norm(v1)
        if n0 < 1e-9 or n1 < 1e-9:
            return ds.start_pos, ds.start_rot, ds.start_scale
        v0 /= n0
        v1 /= n1
        cosang = np.clip(float(v0 @ v1), -1.0, 1.0)
        sign = np.sign(float(np.cross(v0, v1) @ ds.plane_normal)) or 1.0
        ang = float(np.arccos(cosang)) * sign
        if cfg.is_step:
            ang = _snap(ang, cfg.steps[1])
        dq = hm.quat_from_axis_angle(np.asarray(ds.plane_normal, np.float32),
                                     np.float32(ang))
        new_rot = hm.quat_normalize(hm.quat_mul(dq, ds.start_rot))
        return ds.start_pos, np.asarray(new_rot, np.float32), ds.start_scale

    # SCALE
    if ds.handle == Handle.XYZ or not cfg.anisotropic_scale:
        _, s, _ = ray_point_axis(ray_origin, ray_dir, pos0, ds.axis)
        cur = pos0 + np.asarray(ds.axis, np.float64) * s
        base = float(np.linalg.norm(np.asarray(ds.start_point, np.float64) - pos0))
        now = float(np.linalg.norm(cur - pos0))
        f = now / max(base, 1e-6)
        if cfg.is_step:
            f = max(_snap(f, cfg.steps[2]), cfg.steps[2] or 1e-3)
        return ds.start_pos, ds.start_rot, (ds.start_scale * f).astype(np.float32)
    # anisotropic: scale only the dragged axis
    _, s, _ = ray_point_axis(ray_origin, ray_dir, pos0, ds.axis)
    cur = pos0 + np.asarray(ds.axis, np.float64) * s
    base = float((np.asarray(ds.start_point, np.float64) - pos0) @ ds.axis)
    now = float((cur - pos0) @ ds.axis)
    f = now / (base if abs(base) > 1e-6 else 1e-6)
    if cfg.is_step:
        f = max(_snap(f, cfg.steps[2]), cfg.steps[2] or 1e-3)
    sc = np.asarray(ds.start_scale, np.float32).copy()
    sc[int(ds.handle)] *= np.float32(f)
    return ds.start_pos, ds.start_rot, sc
