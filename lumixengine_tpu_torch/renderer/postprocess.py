"""Post-process image passes (counterpart of
``lumixengine_tpu/renderer/postprocess.py``): the builtin RenderPlugins'
shaders (Atmo, CubemapSky, TDAO, SSS, FilmGrain, DOF, Bloom, SSAO, TAA, the
FSR upscale), the tonemap, the decal projection and the clustered
point-light loop, each as torch ops on the device of its inputs.

Conventions: `color` is linear HDR [H, W, 3] f32; `depth` is positive view
distance [H, W] f32, `inf` (or at least 0.99 · far) meaning sky. Scalar
parameters are Python numbers or 0-d tensors; a Python number enters the
float32 arithmetic as the reference's traced scalars do (``_f32``), and no
pass copies anything between host and device.

Two resamplers stand in for the reference's: ``sample_bilinear_clamped``
is ``map_coordinates(order=1, mode="nearest")`` (bilinear with the indices
clamped to the edge; ``sample_nearest_clamped`` its ``order=0``), written
as explicit gathers; ``resize_bilinear``/``resize_nearest`` are
``jax.image.resize``'s half-pixel-centre "bilinear" (upsampling) and
"nearest", i.e. ``F.interpolate`` in "bilinear" (align_corners=False) and
"nearest-exact" mode.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lumixengine_tpu_torch.core import random as prng


# ---------------------------------------------------------------------------
# scalars and resamplers


def _f32(x):
    """A 0-d tensor as it is; a Python number as a float32 scalar."""
    return x if isinstance(x, torch.Tensor) else np.float32(x)


def _tan(x):
    return torch.tan(x) if isinstance(x, torch.Tensor) else np.tan(np.float32(x))


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else np.log(np.float32(x))


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(x)
    return t + torch.where(torch.abs(x - t) >= 0.5, torch.sign(x), torch.zeros_like(x))


def sample_bilinear_clamped(img: torch.Tensor, row: torch.Tensor, col: torch.Tensor):
    """Bilinear sample of img [H, W] at fractional (row, col), each index
    clamped to the edge; the four corners summed in the reference's order
    ((lo, lo), (lo, hi), (hi, lo), (hi, hi))."""
    h, w = img.shape
    r0f, c0f = torch.floor(row), torch.floor(col)
    wr1, wc1 = row - r0f, col - c0f
    wr0, wc0 = 1 - wr1, 1 - wc1
    r0, c0 = r0f.to(torch.int64), c0f.to(torch.int64)
    rs = (torch.clamp(r0, 0, h - 1), torch.clamp(r0 + 1, 0, h - 1))
    cs = (torch.clamp(c0, 0, w - 1), torch.clamp(c0 + 1, 0, w - 1))
    flat = img.reshape(-1)
    out = None
    for ri, wr in zip(rs, (wr0, wr1)):
        for ci, wc in zip(cs, (wc0, wc1)):
            term = (wr * wc) * flat[ri * w + ci]
            out = term if out is None else out + term
    return out


def sample_nearest_clamped(img: torch.Tensor, coords):
    """img[round(c0), round(c1), ...] with each coordinate rounded half away
    from zero and clamped to the edge (``map_coordinates(order=0,
    mode="nearest")``)."""
    idx = 0
    for c, n in zip(coords, img.shape):
        i = torch.clamp(_round_half_away(c).to(torch.int64), 0, n - 1)
        idx = idx * n + i
    return img.reshape(-1)[idx]


def resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[H0, W0] or [H0, W0, C] → [h, w(, C)], half-pixel centres, as
    ``jax.image.resize(..., "bilinear")``: an axis that shrinks is
    antialiased (the triangle kernel widened by the scale), an axis that
    grows is not. An upscale is one plain bilinear call; otherwise each axis
    is its own 1-D resize, antialiased only where it shrinks."""
    x = img[None, None] if img.dim() == 2 else img.permute(2, 0, 1)[None]
    h0, w0 = x.shape[-2:]
    if h >= h0 and w >= w0:
        y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=False)
    else:
        y = x
        for size, shrinks in (((h, w0), h < h0), ((h, w), w < w0)):
            if tuple(y.shape[-2:]) != size:
                y = F.interpolate(y, size=size, mode="bilinear", align_corners=False,
                                  antialias=shrinks)
    return y[0, 0] if img.dim() == 2 else y[0].permute(1, 2, 0)


def resize_nearest(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[H0, W0] or [H0, W0, C] → [h, w(, C)]: source index floor((i + 0.5)
    · H0 / h)."""
    x = img[None, None] if img.dim() == 2 else img.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="nearest-exact")
    return y[0, 0] if img.dim() == 2 else y[0].permute(1, 2, 0)


def _cross(a, b):
    """Cross product over the last axis, broadcasting a against b."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _norm(v, keepdim=True):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def _is_geo(depth, far):
    return torch.isfinite(depth) & (depth < far * 0.99)


# ---------------------------------------------------------------------------
# geometry helpers


def pixel_view_rays(h: int, w: int, fov_y, aspect, device=None):
    """Each pixel centre's view ray slopes (x/z, y/z) [H, W]."""
    t = _tan(_f32(fov_y) * 0.5)
    dev = fov_y.device if isinstance(fov_y, torch.Tensor) else device
    ys = (0.5 - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h) * 2.0 * t
    xs = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w - 0.5) * 2.0 * t \
        * _f32(aspect)
    return xs[None, :].expand(h, w), ys[:, None].expand(h, w)


def view_positions(depth, fov_y, aspect):
    """Depth [H, W] → view-space positions [H, W, 3] (the camera looks down -Z)."""
    h, w = depth.shape
    sx, sy = pixel_view_rays(h, w, fov_y, aspect, depth.device)
    return torch.stack([sx * depth, sy * depth, -depth], dim=-1)


def _rotate_by_quat(q, v):
    """Rotate [..., 3] vectors by one quaternion [4] (x, y, z, w)."""
    u = q[:3].expand(v.shape)
    t = 2.0 * _cross(u, v)
    return v + q[3] * t + _cross(u, t)


def world_rays(cam_rot, fov_y, aspect, h: int, w: int):
    """Unit world-space ray directions [H, W, 3] for the camera quaternion."""
    sx, sy = pixel_view_rays(h, w, fov_y, aspect, cam_rot.device)
    d = torch.stack([sx, sy, -torch.ones_like(sx)], dim=-1)
    d = d / _norm(d)
    return _rotate_by_quat(cam_rot, d)


def world_from_view(pv, cam_pos, cam_rot):
    u = cam_rot[:3].expand(pv.shape)
    t = 2.0 * _cross(u, pv)
    return cam_pos + pv + cam_rot[3] * t + _cross(u, t)


def _project_view(p, fov_y, aspect, h, w):
    """View positions [..., 3] → (row, col) pixel coordinates."""
    t = _tan(_f32(fov_y) * 0.5)
    z = torch.clamp_min(-p[..., 2], 1e-4)
    col = (p[..., 0] / (z * t * _f32(aspect)) * 0.5 + 0.5) * w - 0.5
    row = (0.5 - p[..., 1] / (z * t) * 0.5) * h - 0.5
    return row, col


def view_positions_at(depth, rows, cols, fov_y, aspect, h, w):
    """View positions at fractional pixel coordinates."""
    t = _tan(_f32(fov_y) * 0.5)
    sx = ((cols + 0.5) / w - 0.5) * 2.0 * t * _f32(aspect)
    sy = (0.5 - (rows + 0.5) / h) * 2.0 * t
    return torch.stack([sx * depth, sy * depth, -depth], dim=-1)


def _normals(p):
    """Camera-facing normals from view-position gradients [H, W, 3]."""
    dy = torch.gradient(p, dim=0)[0]
    dx = torch.gradient(p, dim=1)[0]
    n = _cross(dx, dy)
    n = n / torch.clamp_min(_norm(n), 1e-9)
    return torch.where(n[..., 2:3] < 0, -n, n)


# ---------------------------------------------------------------------------
# separable blur, pyramid


def blur5(img):
    """Separable 5-tap binomial blur ([1, 4, 6, 4, 1] / 16) on [H, W(, C)],
    edges replicated."""
    k = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]

    def along(x, axis):
        n = x.shape[axis]
        idx = torch.clamp(torch.arange(-2, n + 2, device=x.device), 0, n - 1)
        xp = x.index_select(axis, idx)
        out = torch.zeros_like(x)
        for i in range(5):
            out = out + np.float32(k[i]) * xp.narrow(axis, i, n)
        return out

    return along(along(img, 0), 1)


def downsample2(img):
    """2x2 average pool (odd sizes replicate the last row/column)."""
    h, w = img.shape[0], img.shape[1]
    if h % 2:
        img = torch.cat([img, img[-1:]], dim=0)
        h += 1
    if w % 2:
        img = torch.cat([img, img[:, -1:]], dim=1)
        w += 1
    return torch.mean(img.reshape((h // 2, 2, w // 2, 2) + img.shape[2:]), dim=(1, 3))


def upsample_to(img, h: int, w: int):
    return resize_bilinear(img, h, w)


# ---------------------------------------------------------------------------
# the plugin passes


def bloom(color, threshold, intensity, levels: int = 3):
    """Bright pass → blurred mip chain → additive composite."""
    h, w = color.shape[:2]
    bright = torch.clamp_min(color - _f32(threshold), 0.0)
    acc = torch.zeros_like(color)
    level = bright
    for _ in range(levels):
        level = blur5(downsample2(level))
        acc = acc + upsample_to(level, h, w)
    return color + _f32(intensity) * (acc / levels)


def ssao(depth, fov_y, aspect, radius, strength, taps: int = 8, far: float = 1e8):
    """Ambient obscurance from the depth buffer: spiral taps tested against
    the normal reconstructed from depth gradients → AO factor [H, W]."""
    h, w = depth.shape
    far = _f32(far)
    d = torch.where(torch.isfinite(depth), depth, far)
    p = view_positions(d, fov_y, aspect)
    n = _normals(p)
    rows = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :].expand(h, w)
    t = _tan(_f32(fov_y) * 0.5)
    radius = _f32(radius)
    px_r = radius / (2.0 * t) * h / torch.clamp_min(d, 1e-3)
    occ = torch.zeros((h, w), device=depth.device)
    golden = 2.399963
    for i in range(taps):
        ang = np.float32(i * golden)
        rr = (i + 1) / taps
        orow = np.sin(ang) * rr * px_r
        ocol = np.cos(ang) * rr * px_r
        sd = sample_bilinear_clamped(d, rows + orow, cols + ocol)
        q = view_positions_at(sd, rows + orow, cols + ocol, fov_y, aspect, h, w)
        v = q - p
        vn = torch.sum(v * n, dim=-1)
        vv = torch.sum(v * v, dim=-1)
        occ = occ + torch.clamp_min(vn - 0.02 * d, 0.0) / (vv + 1e-4)
    ao = torch.clamp(1.0 - _f32(strength) * occ * (radius / taps), 0.05, 1.0)
    return torch.where(_is_geo(depth, far), ao, 1.0)


def sss_shadow(depth, fov_y, aspect, sun_view, steps: int = 8, max_dist=0.5, shadow=0.45,
               far: float = 1e8):
    """Screen-space contact shadows: a short depth-buffer march toward the
    sun → light factor [H, W] in [shadow, 1]."""
    h, w = depth.shape
    far = _f32(far)
    d = torch.where(torch.isfinite(depth), depth, far)
    p = view_positions(d, fov_y, aspect)
    sdir = sun_view / torch.clamp_min(_norm(sun_view, keepdim=False), 1e-9)
    occluded = torch.zeros((h, w), dtype=torch.bool, device=depth.device)
    for i in range(1, steps + 1):
        s = p + sdir * np.float32(max_dist * i / steps)
        row, col = _project_view(s, fov_y, aspect, h, w)
        sd = sample_bilinear_clamped(d, row, col)
        sz = -s[..., 2]
        occluded = occluded | ((sd < sz - 0.02) & (sd > sz - max_dist * 2.0))
    lit = torch.where(occluded, _f32(shadow), np.float32(1.0))
    return torch.where(_is_geo(depth, far), lit, 1.0)


def tdao_heightmap(ipos, irad, bounds_min, inv_extent, grid: int = 128):
    """Top-down height grid [grid, grid]: the max of the sphere tops over an
    XZ grid (-1e9 where none lands)."""
    gx = torch.clamp(((ipos[:, 0] - bounds_min[0]) * inv_extent[0] * grid).to(torch.int64),
                     0, grid - 1)
    gz = torch.clamp(((ipos[:, 2] - bounds_min[1]) * inv_extent[1] * grid).to(torch.int64),
                     0, grid - 1)
    tops = ipos[:, 1] + irad
    hm = torch.full((grid * grid,), -1e9, dtype=torch.float32, device=ipos.device)
    return hm.scatter_reduce(0, gz * grid + gx, tops, "amax", include_self=True) \
        .reshape(grid, grid)


def tdao(depth, heightmap, cam_pos, cam_rot, fov_y, aspect, bounds_min, inv_extent, strength,
         falloff=0.35, far: float = 1e8):
    """Darken pixels lying under nearby geometry tops → AO factor [H, W]."""
    grid = heightmap.shape[0]
    far = _f32(far)
    d = torch.where(torch.isfinite(depth), depth, far)
    pw_ = world_from_view(view_positions(d, fov_y, aspect), cam_pos, cam_rot)
    hm = heightmap
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            hm = torch.maximum(hm, torch.roll(heightmap, (dr, dc), (0, 1)))
    col = torch.clamp((pw_[..., 0] - bounds_min[0]) * inv_extent[0] * grid, 0, grid - 1)
    row = torch.clamp((pw_[..., 2] - bounds_min[1]) * inv_extent[1] * grid, 0, grid - 1)
    hmax = sample_bilinear_clamped(hm, row, col)
    over = torch.clamp_min(hmax - pw_[..., 1], 0.0)
    ao = torch.clamp(1.0 - _f32(strength) * (1.0 - torch.exp(-over * _f32(falloff))), 0.2, 1.0)
    return torch.where(_is_geo(depth, far), ao, 1.0)


def _pow8(x):
    x2 = x * x
    x4 = x2 * x2
    return x4 * x4


def atmo(color, depth, rays, sun_dir, far):
    """Analytic sky where the depth buffer is empty, distance fog on
    geometry."""
    dev = color.device
    far = _f32(far)
    sun = sun_dir / torch.clamp_min(_norm(sun_dir, keepdim=False), 1e-9)
    mu = torch.sum(rays * sun, dim=-1)
    up = torch.clamp(rays[..., 1], -1.0, 1.0)
    horizon = torch.exp(-torch.clamp_min(up, 0.0) * 4.0)
    zenith = torch.tensor([0.18, 0.34, 0.72], device=dev)
    haze = torch.tensor([0.75, 0.82, 0.92], device=dev)
    sky = zenith * (1 - horizon[..., None]) + haze * horizon[..., None]
    mie = 0.25 * _pow8(torch.clamp_min(mu, 0.0))
    disc = torch.where(mu > 0.9995, np.float32(4.0), np.float32(0.0))
    sun_col = torch.tensor([1.0, 0.93, 0.82], device=dev)
    sky = sky + (mie + disc)[..., None] * sun_col
    ground = torch.tensor([0.16, 0.15, 0.14], device=dev) \
        * (0.4 + 0.6 * torch.exp(up * 6.0))[..., None]
    sky = torch.where(up[..., None] < 0, ground, sky)
    is_sky = ~_is_geo(depth, far)
    out = torch.where(is_sky[..., None], sky, color)
    fog = 1.0 - torch.exp(-torch.where(is_sky, np.float32(0.0), depth) * (1.5 / far))
    return out * (1 - fog[..., None]) + haze * fog[..., None]


def cubemap_sky(color, depth, rays, faces, far):
    """Sample a [6, S, S, 3] cubemap by ray direction where the depth buffer
    is empty; face order +X, -X, +Y, -Y, +Z, -Z."""
    s = faces.shape[1]
    ax, ay, az = rays[..., 0], rays[..., 1], rays[..., 2]
    aax, aay, aaz = torch.abs(ax), torch.abs(ay), torch.abs(az)
    fx = torch.where(ax > 0, 0, 1)
    fy = torch.where(ay > 0, 2, 3)
    fz = torch.where(az > 0, 4, 5)
    face = torch.where((aax >= aay) & (aax >= aaz), fx, torch.where(aay >= aaz, fy, fz))
    m = torch.maximum(torch.maximum(aax, aay), aaz)
    us = (-az, az, ax, ax, ax, -ax)
    vs = (-ay, -ay, az, -az, -ay, -ay)
    u, v = torch.zeros_like(ax), torch.zeros_like(ax)
    for f in range(6):
        u = torch.where(face == f, us[f], u)
        v = torch.where(face == f, vs[f], v)
    u, v = u / m, v / m
    col = torch.clamp((u * 0.5 + 0.5) * (s - 1), 0, s - 1)
    row = torch.clamp((v * 0.5 + 0.5) * (s - 1), 0, s - 1)
    ff = face.to(torch.float32)
    sky = torch.stack([sample_nearest_clamped(faces[..., c], (ff, row, col)) for c in range(3)],
                      dim=-1)
    is_sky = ~_is_geo(depth, _f32(far))
    return torch.where(is_sky[..., None], sky, color)


def dof(color, depth, focus_dist, focus_range, max_amount=0.85, far: float = 1e8):
    """Circle-of-confusion lerp toward a blurred mip."""
    d = torch.where(torch.isfinite(depth), depth, _f32(far))
    blurred = upsample_to(blur5(downsample2(blur5(downsample2(color)))), *color.shape[:2])
    coc = torch.clamp(torch.abs(d - _f32(focus_dist)) / _f32(focus_range), 0.0, 1.0)
    coc = (coc * coc * _f32(max_amount))[..., None]
    return color * (1 - coc) + blurred * coc


def taa(color, history, alpha):
    """History blend with a 3x3 neighbourhood clamp."""
    lo, hi = color, color
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            r = torch.roll(color, (dr, dc), (0, 1))
            lo = torch.minimum(lo, r)
            hi = torch.maximum(hi, r)
    hist = torch.minimum(torch.maximum(history, lo), hi)
    return hist + (color - hist) * _f32(alpha)


def film_grain(color, key, amount):
    """Per-pixel multiplicative noise: threefry `uniform(key, [H, W])`, bit
    for bit the reference's draw."""
    n = prng.uniform(key, color.shape[:2]) - 0.5
    return torch.clamp_min(color * (1.0 + n[..., None] * _f32(amount)), 0.0)


def tonemap_aces(color, exposure):
    """ACES fitted curve, linear HDR → display [0, 1]."""
    x = color * _f32(exposure)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def _sharpen4(up, sharpness):
    lo, hi, acc = up, up, torch.zeros_like(up)
    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        r = torch.roll(up, (dr, dc), (0, 1))
        lo = torch.minimum(lo, r)
        hi = torch.maximum(hi, r)
        acc = acc + r
    sharp = up + (up - acc / 4.0) * _f32(sharpness)
    return torch.minimum(torch.maximum(sharp, lo), hi)


def fsr_upscale(color, out_h: int, out_w: int, sharpness):
    """Bilinear upscale and a contrast-adaptive sharpen clamped to the
    4-neighbourhood."""
    return _sharpen4(resize_bilinear(color, out_h, out_w), sharpness)


def decal_pass(color, depth, fov_y, aspect, cam_pos, cam_rot, dpos, drot, dhe, tints,
               alpha=0.65, far: float = 1e8):
    """Project each decal's box onto the depth buffer: geometry pixels whose
    world position falls inside take the decal's tint. dpos [D, 3], drot
    [D, 4], dhe [D, 3], tints [D, 3]; the decals blend in order."""
    far = _f32(far)
    d = torch.where(torch.isfinite(depth), depth, far)
    pw = world_from_view(view_positions(d, fov_y, aspect), cam_pos, cam_rot)
    geo = _is_geo(depth, far)[..., None]
    alpha = _f32(alpha)
    out = color
    for i in range(dpos.shape[0]):
        qi = drot[i]
        inv = torch.cat([-qi[:3], qi[3:4]])
        local = _rotate_by_quat(inv, pw - dpos[i])
        inside = torch.all(torch.abs(local) <= dhe[i], dim=-1)[..., None] & geo
        out = torch.where(inside, out * (1 - alpha) + tints[i] * alpha, out)
    return out


def deferred_lights(color, depth, fov_y, aspect, lpos_view, lcolor, lintensity, lrange,
                    cluster_lights, grid, near, far_cluster, far: float = 1e8):
    """The clustered light loop: each pixel's view position and normal from
    depth, its cluster, and diffuse N·L with a smooth range falloff from the
    cluster's lights. lpos_view [L, 3], lcolor [L, 3], cluster_lights
    [C, MAX] (-1 padded, ``clusters.fill_clusters``), grid (nx, ny, nz)."""
    h, w = depth.shape
    nx, ny, nz = grid
    far = _f32(far)
    near, far_cluster = _f32(near), _f32(far_cluster)
    d = torch.where(torch.isfinite(depth), depth, far)
    p = view_positions(d, fov_y, aspect)
    n = _normals(p)
    rows = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    cx = torch.clamp((cols / w * nx).to(torch.int64), 0, nx - 1)
    cy = (ny - 1) - torch.clamp((rows / h * ny).to(torch.int64), 0, ny - 1)
    if isinstance(near, torch.Tensor) or isinstance(far_cluster, torch.Tensor):
        dc = torch.minimum(torch.maximum(d, near), far_cluster)
    else:
        dc = torch.clamp(d, float(near), float(far_cluster))
    t = torch.log(dc / near) / _log(far_cluster / near)
    cz = torch.clamp((t * nz).to(torch.int64), 0, nz - 1)
    cidx = (cz * ny + cy) * nx + cx                        # [nz, ny, nx] flattened
    slots = cluster_lights[cidx]                           # [H, W, MAX]
    acc = torch.zeros(depth.shape + (3,), device=depth.device)
    for k in range(slots.shape[-1]):
        li = slots[..., k]
        ok = (li >= 0)[..., None]
        lif = torch.clamp_min(li, 0).to(torch.int64)
        lv = lpos_view[lif] - p
        dist = _norm(lv)
        ndotl = torch.clamp_min(torch.sum(n * lv / torch.clamp_min(dist, 1e-6), dim=-1,
                                          keepdim=True), 0.0)
        rng = lrange[lif][..., None]
        ratio = dist / torch.clamp_min(rng, 1e-6)
        fall = torch.clamp(1.0 - ratio * ratio, 0.0, 1.0)
        inten = lintensity[lif][..., None]
        acc = acc + torch.where(ok, lcolor[lif] * (ndotl * (fall * fall) * inten
                                                   / (1.0 + dist * dist)), 0.0)
    geo = _is_geo(depth, far)[..., None]
    return color + torch.where(geo, color * acc, 0.0)


def default_cubemap(size: int = 64, device=None):
    """Procedural fallback cubemap [6, S, S, 3] (vertical gradient)."""
    faces = np.zeros((6, size, size, 3), np.float32)
    v = np.linspace(1.0, -1.0, size)[:, None]
    for f in range(6):
        up = {2: 1.0, 3: -1.0}.get(f, 0.0)
        grad = np.clip(0.5 + 0.5 * (v * (0.0 if f in (2, 3) else 1.0) + up), 0.0, 1.0)
        faces[f] = (np.asarray([0.2, 0.35, 0.7])[None, None] * (0.4 + 0.6 * grad[..., None])
                    + np.asarray([0.5, 0.45, 0.35])[None, None] * (1.0 - grad[..., None]) * 0.5)
    return torch.as_tensor(faces, device=device)
