"""FSR3-structured temporal upscaler (counterpart of
``lumixengine_tpu/renderer/fsr3.py``), as torch ops on the inputs' device.

Passes: (1) reconstruct & dilate — nearest-depth 3x3 dilation of depth and
motion; (2) depth clip — reproject by the dilated motion and compare with
the previous dilated depth → disocclusion mask; (3) create locks — thin
luma features; (4) upscale & accumulate — a Lanczos(2) resample of the
jittered frame blended with the reprojected history rectified to the
neighbourhood box (relaxed under locks, reset under disocclusion); then
RCAS. ``FSR3State`` holds the history at presentation resolution, the lock
lifetimes, the previous dilated depth and the frame index.

Conventions: color [h, w, 3] linear HDR at render resolution, depth
[h, w] (inf = sky), motion [h, w, 2] in UV units (uv_prev - uv_cur);
output and history [H, W, 3] at presentation resolution.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from lumixengine_tpu_torch.renderer.postprocess import (_cross, _f32, _tan,
                                                        sample_bilinear_clamped, view_positions,
                                                        world_from_view)

LOCK_LIFETIME = 8.0        # frames a fresh lock survives
DISOCC_SCALE = 0.1         # depth-relative disocclusion threshold
ACCUM_MAX = 0.92           # history weight ceiling (about a 12-frame window)


@dataclass
class FSR3State:
    history: torch.Tensor     # f32 [H, W, 3] accumulated presentation colour
    lock: torch.Tensor        # f32 [H, W] remaining lock lifetime (frames)
    prev_depth: torch.Tensor  # f32 [h, w] previous dilated depth
    frame: torch.Tensor       # int32 [] jitter phase / reset detector


def init_state(h: int, w: int, out_h: int, out_w: int, device=None) -> FSR3State:
    return FSR3State(
        history=torch.zeros((out_h, out_w, 3), dtype=torch.float32, device=device),
        lock=torch.zeros((out_h, out_w), dtype=torch.float32, device=device),
        prev_depth=torch.full((h, w), math.inf, dtype=torch.float32, device=device),
        frame=torch.zeros((), dtype=torch.int32, device=device),
    )


def halton(i, base: int):
    """Halton radical inverse of i (an int tensor) in float32, 8 digits."""
    f, r = 1.0, torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    for _ in range(8):
        f = np.float32(f / base)
        r = r + f * torch.remainder(i, base).to(torch.float32)
        i = torch.div(i, base, rounding_mode="floor")
    return r


def jitter(frame, phase_count: int):
    """Sub-pixel jitter [2] in render pixels, centred on 0."""
    frame = torch.as_tensor(frame, dtype=torch.int32)
    i = torch.remainder(frame, phase_count) + 1
    return torch.stack([halton(i, 2) - 0.5, halton(i, 3) - 0.5])


def _luma(c):
    return c[..., 0] * 0.299 + c[..., 1] * 0.587 + c[..., 2] * 0.114


def reconstruct_dilate(depth, motion):
    """Each pixel takes the nearest (minimum) depth of its 3x3 neighbourhood
    and that neighbour's motion."""
    best_d, best_m = depth, motion
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr == 0 and dc == 0:
                continue
            d = torch.roll(depth, (dr, dc), (0, 1))
            m = torch.roll(motion, (dr, dc), (0, 1))
            closer = d < best_d
            best_d = torch.where(closer, d, best_d)
            best_m = torch.where(closer[..., None], m, best_m)
    return best_d, best_m


def depth_clip(dil_depth, dil_motion, prev_depth):
    """Reactive mask in [0, 1] (1 = disoccluded): last frame's depth at the
    reprojected position against this frame's."""
    h, w = dil_depth.shape
    dev = dil_depth.device
    rows = torch.arange(h, device=dev)[:, None] + dil_motion[..., 1] * h
    cols = torch.arange(w, device=dev)[None, :] + dil_motion[..., 0] * w
    prev = sample_bilinear_clamped(prev_depth, rows, cols)
    finite = torch.isfinite(dil_depth) & torch.isfinite(prev)
    err = torch.abs(prev - dil_depth) / torch.clamp_min(torch.abs(dil_depth), 1e-3)
    react = torch.clamp(err / DISOCC_SCALE - 1.0, 0.0, 1.0)
    flip = torch.isfinite(dil_depth) ^ torch.isfinite(prev)
    return torch.where(finite, react, torch.where(flip, np.float32(1.0), np.float32(0.0)))


def create_locks(color):
    """New-lock mask [h, w] in {0, 1}: strict luma extrema against the
    4-neighbourhood."""
    y = _luma(color)
    ring_max = ring_min = None
    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        r = torch.roll(y, (dr, dc), (0, 1))
        ring_max = r if ring_max is None else torch.maximum(ring_max, r)
        ring_min = r if ring_min is None else torch.minimum(ring_min, r)
    feature = (y > ring_max * 1.15 + 1e-4) | (y < ring_min * 0.85 - 1e-4)
    return feature.to(torch.float32)


def _lanczos2(x):
    """Lanczos(2) kernel, safe at 0."""
    ax = torch.abs(x)
    pix = np.float32(np.pi) * torch.where(ax < 1e-4, np.float32(1e-4), ax)
    k = (2.0 * torch.sin(pix) * torch.sin(pix / 2.0)) / (pix * pix)
    k = torch.where(ax < 1e-4, np.float32(1.0), k)
    return torch.where(ax < 2.0, k, np.float32(0.0))


def _upsample_lanczos(color, out_h, out_w, jit_px):
    """4x4 Lanczos(2) resample of the jittered frame onto the output grid,
    and each output pixel's confidence in (0, 1] (the largest tap weight)."""
    h, w, _ = color.shape
    dev = color.device
    sy, sx = h / out_h, w / out_w
    ry = (torch.arange(out_h, device=dev) + 0.5) * sy - 0.5 - jit_px[1]
    rx = (torch.arange(out_w, device=dev) + 0.5) * sx - 0.5 - jit_px[0]
    fy, fx = torch.floor(ry), torch.floor(rx)
    out = torch.zeros((out_h, out_w, 3), device=dev)
    wsum = torch.zeros((out_h, out_w, 1), device=dev)
    conf = torch.zeros((out_h, out_w), device=dev)
    for oy in (-1, 0, 1, 2):
        wy = _lanczos2(ry - (fy + oy))[:, None]
        iy = torch.clamp(fy + oy, 0, h - 1).to(torch.int64)
        rows = color.index_select(0, iy)
        for ox in (-1, 0, 1, 2):
            wx = _lanczos2(rx - (fx + ox))[None, :]
            ix = torch.clamp(fx + ox, 0, w - 1).to(torch.int64)
            smp = rows.index_select(1, ix)
            wgt = (wy * wx)[..., None]
            out = out + smp * wgt
            wsum = wsum + wgt
            conf = torch.maximum(conf, wgt[..., 0])
    return out / torch.clamp_min(wsum, 1e-6), torch.clamp(conf, 0.0, 1.0)


def accumulate(state: FSR3State, color, dil_motion, react, new_locks, out_h: int, out_w: int,
               jit_px):
    """Upscale & accumulate → (output [H, W, 3], lock [H, W])."""
    h, w, _ = color.shape
    dev = color.device
    cur, conf = _upsample_lanczos(color, out_h, out_w, jit_px)
    ry = torch.clamp((torch.arange(out_h, device=dev) * h) // out_h, 0, h - 1)
    rx = torch.clamp((torch.arange(out_w, device=dev) * w) // out_w, 0, w - 1)

    def up_n(x):
        return x.index_select(0, ry).index_select(1, rx)

    react_u, motion_u, locks_u = up_n(react), up_n(dil_motion), up_n(new_locks)
    rows = torch.arange(out_h, device=dev)[:, None] + motion_u[..., 1] * out_h
    cols = torch.arange(out_w, device=dev)[None, :] + motion_u[..., 0] * out_w
    hist = torch.stack([sample_bilinear_clamped(state.history[..., c], rows, cols)
                        for c in range(3)], dim=-1)
    lock = sample_bilinear_clamped(state.lock, rows, cols)
    lock = torch.clamp_min(lock - 1.0, 0.0) + locks_u * LOCK_LIFETIME
    lo, hi = cur, cur
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            r = torch.roll(cur, (dr, dc), (0, 1))
            lo = torch.minimum(lo, r)
            hi = torch.maximum(hi, r)
    relax = torch.maximum(torch.clamp(lock / LOCK_LIFETIME, 0.0, 1.0), 1.0 - conf)[..., None]
    span = (hi - lo) * 0.5
    lo = lo - span * relax * 2.0
    hi = hi + span * relax * 2.0
    hist_rect = torch.minimum(torch.maximum(hist, lo), hi)
    alpha_cur = np.float32(1.0 - ACCUM_MAX) * (0.35 + 0.65 * conf)[..., None]
    alpha_hist = (1.0 - alpha_cur) * (1.0 - react_u)[..., None]
    alpha_hist = torch.where(state.frame == 0, np.float32(0.0), alpha_hist)
    out = hist_rect * alpha_hist + cur * (1.0 - alpha_hist)
    lock = torch.where(react_u > 0.5, np.float32(0.0), lock)
    return out, lock


def rcas(color, sharpness):
    """Contrast-adaptive sharpen clamped to the 4-neighbourhood."""
    from lumixengine_tpu_torch.renderer.postprocess import _sharpen4

    return _sharpen4(color, sharpness)


def dispatch(state: FSR3State, color, depth, motion, out_h: int, out_w: int, sharpness=0.5):
    """One FSR3 frame: passes 1-4 and RCAS → (output [H, W, 3], new state).
    `motion` is uv_prev - uv_cur at render resolution (zeros for a static
    camera)."""
    h = color.shape[0]
    phase = int(8 * (out_h / h) ** 2) or 8
    jit_px = jitter(state.frame, phase).to(color.device)
    dil_depth, dil_motion = reconstruct_dilate(depth, motion)
    react = depth_clip(dil_depth, dil_motion, state.prev_depth)
    new_locks = create_locks(color)
    out, lock = accumulate(state, color, dil_motion, react, new_locks, out_h, out_w, jit_px)
    return rcas(out, sharpness), FSR3State(history=out, lock=lock, prev_depth=dil_depth,
                                           frame=state.frame + 1)


def camera_motion_vectors(depth, fov_y, aspect, cam_pos, cam_rot, prev_cam_pos, prev_cam_rot,
                          far: float = 1e8):
    """Camera-only motion vectors [h, w, 2]: each pixel's world position
    from depth projected into the previous camera, uv_prev - uv_cur."""
    h, w = depth.shape
    dev = depth.device
    d = torch.where(torch.isfinite(depth), depth, _f32(far))
    pw = world_from_view(view_positions(d, fov_y, aspect), cam_pos, cam_rot)
    q = prev_cam_rot
    inv = torch.cat([-q[:3], q[3:4]])
    rel = pw - prev_cam_pos
    u = inv[:3].expand(rel.shape)
    t = 2.0 * _cross(u, rel)
    pv = rel + inv[3] * t + _cross(u, t)
    z = torch.clamp_min(-pv[..., 2], 1e-6)
    th = _tan(_f32(fov_y) * 0.5)
    aspect = _f32(aspect)
    u_prev = 0.5 + pv[..., 0] / (2.0 * th * aspect * z)
    v_prev = 0.5 - pv[..., 1] / (2.0 * th * z)
    uc = (torch.arange(w, device=dev)[None, :] + 0.5) / w
    vc = (torch.arange(h, device=dev)[:, None] + 0.5) / h
    return torch.stack([u_prev - uc.expand(h, w), v_prev - vc.expand(h, w)], dim=-1)
