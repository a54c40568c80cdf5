"""Rigid-body operators on tensors (counterpart of
``lumixengine_tpu/ops/physics_ops.py``), the subset the pruned broadphase
branch runs: velocity/position integration, world AABBs, ground and pair
contacts for spheres and boxes, tangent frames, the world inverse inertia and
sleeping.

SoA layout, body axis last: pos ``[..., 3, NB]``, rot ``[..., 4, NB]``.
Contact slots are ``[..., C]`` / ``[..., 3, C]``; normals point from body a
to body b. Where the reference gathered with one-hot contractions (a TPU
layout rule), this port gathers by index; the values are the same.
Per-contact arrays ``[..., C]`` that meet ``[..., 3, C]`` arrays are given an
explicit component axis, because the batch axis is written out here instead
of ``vmap``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from lumixengine_tpu_torch.core import math as lm

AX = -2  # component axis for [C, N] SoA arrays

SHAPE_SPHERE = 0
SHAPE_BOX = 1
SHAPE_CAPSULE = 2
SHAPE_CONVEX = 3

# unit-cube corner signs [3, 8]
_CORNER_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32).T


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., NB] gathered at idx [..., P] (int64) → [..., P]. x may lack
    idx's batch axes (static per-body data)."""
    if idx.dim() == 1:
        return x.index_select(-1, idx)
    batch = torch.broadcast_shapes(x.shape[:-1], idx.shape[:-1])
    return torch.gather(x.expand(batch + x.shape[-1:]), -1, idx.expand(batch + idx.shape[-1:]))


def take_vecs(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., c, NB] gathered at idx [..., P] (int64) → [..., c, P]."""
    if idx.dim() == 1:
        return x.index_select(-1, idx)
    batch = torch.broadcast_shapes(x.shape[:-2], idx.shape[:-1])
    c = x.shape[-2]
    return torch.gather(x.expand(batch + x.shape[-2:]), -1,
                        idx.unsqueeze(-2).expand(batch + (c, idx.shape[-1])))


def top_k_stable(x: torch.Tensor, k: int):
    """Largest k along the last axis; ties keep the lower index first, as
    ``jax.lax.top_k`` does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def integrate_velocities(vel, angvel, dt, gravity, lin_damping, ang_damping, dyn_mask):
    """Semi-implicit Euler velocity update (gravity + exponential damping)."""
    m = dyn_mask.unsqueeze(-2)
    v = vel + gravity[:, None] * dt
    v = v * torch.exp(-lin_damping * dt)
    w = angvel * torch.exp(-ang_damping * dt)
    return torch.where(m, v, vel), torch.where(m, w, angvel)


def integrate_positions(pos, rot, vel, angvel, dt, dyn_mask):
    """x += v·dt; q += ½·(ω⊗q)·dt, renormalized."""
    m = dyn_mask.unsqueeze(-2)
    new_pos = pos + vel * dt
    wx, wy, wz = lm.unstack(angvel, AX)
    wq = torch.stack([wx, wy, wz, torch.zeros_like(wx)], dim=AX)
    dq = lm.quat_mul(wq, rot, axis=AX) * (0.5 * dt)
    new_rot = lm.quat_normalize(rot + dq, axis=AX)
    return torch.where(m, new_pos, pos), torch.where(m, new_rot, rot)


@functools.lru_cache(maxsize=None)
def _corner_signs(device: torch.device) -> torch.Tensor:
    """The corner signs on `device`, copied there once: a copy from the host
    per call would wait for the device each time."""
    return torch.as_tensor(_CORNER_SIGNS, device=device)


def box_corners(pos, rot, half_extents):
    """World-space box corners: [..., 3, 8, NB]."""
    signs = _corner_signs(pos.device)
    local = half_extents[..., :, None, :] * signs[:, :, None]
    return pos[..., :, None, :] + lm.quat_rotate(rot[..., :, None, :], local, axis=-3)


def world_aabb(pos, rot, shape, radius, half_extents):
    """Conservative world AABB per body → (mins [..,3,NB], maxs [..,3,NB])."""
    z = torch.zeros_like(radius)
    ex = torch.abs(lm.quat_rotate(rot, torch.stack([half_extents[..., 0, :], z, z], dim=AX), axis=AX))
    ey = torch.abs(lm.quat_rotate(rot, torch.stack([z, half_extents[..., 1, :], z], dim=AX), axis=AX))
    ez = torch.abs(lm.quat_rotate(rot, torch.stack([z, z, half_extents[..., 2, :]], dim=AX), axis=AX))
    box_ext = ex + ey + ez
    r = radius[..., None, :]
    ext = torch.where((shape == SHAPE_BOX)[..., None, :], box_ext, r.expand(box_ext.shape))
    return pos - ext, pos + ext


class Contacts(NamedTuple):
    """Dense contact slots. body_a/body_b are int64 [C] (static) or [..., C]
    (per world); body_b == -1 is a contact with the static ground."""

    body_a: torch.Tensor
    body_b: torch.Tensor
    point: torch.Tensor   # f32 [..., 3, C]
    normal: torch.Tensor  # f32 [..., 3, C] (a → b)
    depth: torch.Tensor   # f32 [..., C] penetration (> 0 = penetrating)
    active: torch.Tensor  # bool [..., C]


def _slot_masks(k: int, device):
    slot0 = (torch.arange(k, device=device) == 0).to(torch.float32)
    return slot0[:, None], (1.0 - slot0)[:, None]


def ground_contacts(pos, rot, shape, radius, half_extents, dyn_mask,
                    ground_y: float = 0.0, slots_per_body: int = 4) -> Contacts:
    """Contacts of every dynamic body vs the plane y = ground_y (normal +Y):
    boxes give their `slots_per_body` deepest corners, spheres their lowest
    point. Slot layout [k, NB] flattened. Capsules are outside the slice."""
    nb = pos.shape[-1]
    k = slots_per_body
    corners = box_corners(pos, rot, half_extents)             # [..,3,8,NB]
    c_depth = ground_y - corners[..., 1, :, :]                # [..,8,NB]
    top_d, top_i = top_k_stable(c_depth.transpose(-1, -2), k)  # [..,NB,k]
    ci = top_i.transpose(-1, -2)                              # [..,k,NB]
    box_pts = torch.gather(corners, -2, ci.unsqueeze(-3).expand(ci.shape[:-2] + (3,) + ci.shape[-2:]))
    box_dep = top_d.transpose(-1, -2)                         # [..,k,NB]

    z = torch.zeros_like(radius)
    sph_low = pos - torch.stack([z, radius, z], dim=AX)
    sph_dep = ground_y - sph_low[..., 1, :]
    slot0, not0 = _slot_masks(k, pos.device)
    sph_pts = sph_low[..., :, None, :] * slot0
    sph_deps = sph_dep[..., None, :] * slot0 - not0
    is_box = shape == SHAPE_BOX
    pts = torch.where(is_box[..., None, None, :], box_pts, sph_pts)
    dep = torch.where(is_box[..., None, :], box_dep, sph_deps)
    c = k * nb
    point = pts.reshape(pts.shape[:-2] + (c,))
    depth = dep.reshape(dep.shape[:-2] + (c,))
    normal = torch.zeros_like(point)
    normal[..., 1, :] = -1.0
    body_a = torch.arange(nb, device=pos.device).repeat(k)
    active = (depth > 0.0) & dyn_mask[..., body_a]
    return Contacts(body_a=body_a, body_b=torch.full_like(body_a, -1), point=point,
                    normal=normal, depth=depth, active=active)


def pair_contacts(pos, rot, shape, radius, half_extents, pair_a, pair_b,
                  points_per_pair: int = 4) -> Contacts:
    """Narrowphase over a pair list (int64 [P] or per world [..., P]):
    sphere-sphere single point, sphere-box closest feature, box-box the
    `points_per_pair` deepest corners. C = points_per_pair · P slots.
    PhysStatics refuses capsules, so there are none here."""
    k = points_per_pair
    point, normal, depth, active = pair_contacts_from_data(
        take_vecs(pos, pair_a), take_vecs(rot, pair_a), take_rows(radius, pair_a),
        take_vecs(half_extents, pair_a), take_rows(shape, pair_a),
        take_vecs(pos, pair_b), take_vecs(rot, pair_b), take_rows(radius, pair_b),
        take_vecs(half_extents, pair_b), take_rows(shape, pair_b), points_per_pair=k,
        any_caps=False)
    return Contacts(body_a=pair_a.tile((k,)), body_b=pair_b.tile((k,)), point=point,
                    normal=normal, depth=depth, active=active)


def _sphere_sphere(pa, ra, pb, rb):
    d = pb - pa
    dist = torch.sqrt(torch.clamp_min(torch.sum(d * d, dim=AX), 1e-12))
    n = d / dist[..., None, :]
    depth = (ra + rb) - dist
    point = pa + n * ra[..., None, :]
    return point, n, depth


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def pair_contacts_from_data(pos_a, rot_a, rad_a, he_a, shape_a,
                            pos_b, rot_b, rad_b, he_b, shape_b,
                            points_per_pair: int = 4, any_caps: bool = True):
    """Narrowphase core on gathered per-pair arrays ([..., P] / [..., 3|4, P])
    → (point, normal, depth, active) in slot-major [k, P] flattened layout.
    Sphere and box shapes only: capsules are not ported, so the caller says
    none is present (`any_caps=False`, decided on the host from the shape
    table, as in the reference)."""
    if any_caps:
        raise NotImplementedError("capsule contacts are not ported")
    P = pos_a.shape[-1]
    k = points_per_pair
    dev = pos_a.device

    ss_pt, ss_n, ss_d = _sphere_sphere(pos_a, rad_a, pos_b, rad_b)

    # sphere(a) vs box(b): clamp sphere center into b
    invb = lm.quat_conjugate(rot_b, axis=AX)
    ca_in_b = lm.quat_rotate(invb, pos_a - pos_b, axis=AX)
    clamped = _clip(ca_in_b, -he_b, he_b)
    closest_w = pos_b + lm.quat_rotate(rot_b, clamped, axis=AX)
    delta = closest_w - pos_a
    dist = torch.sqrt(torch.clamp_min(torch.sum(delta * delta, dim=AX), 1e-12))
    sb_n = delta / dist[..., None, :]
    sb_d = rad_a - dist
    sb_pt = closest_w

    # box(a) vs sphere(b): mirrored
    inva = lm.quat_conjugate(rot_a, axis=AX)
    cb_in_a = lm.quat_rotate(inva, pos_b - pos_a, axis=AX)
    clamped2 = _clip(cb_in_a, -he_a, he_a)
    closest2 = pos_a + lm.quat_rotate(rot_a, clamped2, axis=AX)
    delta2 = pos_b - closest2
    dist2 = torch.sqrt(torch.clamp_min(torch.sum(delta2 * delta2, dim=AX), 1e-12))
    bs_n = delta2 / dist2[..., None, :]
    bs_d = rad_b - dist2
    bs_pt = closest2

    # box-box: SAT over the 6 face axes; manifold = the incident box's
    # deepest corners against the reference face
    eye = torch.eye(3, dtype=torch.float32, device=dev)

    def box_axes(rot):
        return [lm.quat_rotate(rot, eye[i][:, None], axis=AX) for i in range(3)]

    axes_a = box_axes(rot_a)
    axes_b = box_axes(rot_b)
    d_ab = pos_b - pos_a

    def proj(axes, he, u):
        return sum(he[..., i, :] * torch.abs(torch.sum(axes[i] * u, dim=AX)) for i in range(3))

    ca = box_corners(pos_a, rot_a, he_a)  # [..,3,8,P]
    cb = box_corners(pos_b, rot_b, he_b)

    best_overlap = best_n = best_from_a = None
    for src, u_list in ((0, axes_a), (1, axes_b)):
        for u in u_list:
            du = torch.sum(d_ab * u, dim=AX)
            overlap = proj(axes_a, he_a, u) + proj(axes_b, he_b, u) - torch.abs(du)
            n_u = u * torch.sign(torch.where(du == 0, 1.0, du)).unsqueeze(AX)
            if best_overlap is None:
                best_overlap, best_n = overlap, n_u
                best_from_a = torch.full(overlap.shape, src == 0, device=dev)
            else:
                better = overlap < best_overlap
                best_n = torch.where(better.unsqueeze(AX), n_u, best_n)
                best_from_a = torch.where(better, src == 0, best_from_a)
                best_overlap = torch.minimum(overlap, best_overlap)

    n_bb = best_n
    sup_a = torch.sum(pos_a * n_bb, dim=AX) + proj(axes_a, he_a, n_bb)
    sup_b = torch.sum(pos_b * n_bb, dim=AX) - proj(axes_b, he_b, n_bb)
    dep_b_corners = sup_a[..., None, :] - torch.sum(cb * n_bb[..., :, None, :], dim=-3)
    dep_a_corners = torch.sum(ca * n_bb[..., :, None, :], dim=-3) - sup_b[..., None, :]
    from_a = best_from_a[..., None, :]
    all_dep = torch.where(from_a, dep_b_corners, dep_a_corners)
    all_pts = torch.where(from_a.unsqueeze(-3), cb, ca)
    all_dep = torch.minimum(all_dep, best_overlap[..., None, :])
    all_dep = torch.where(best_overlap[..., None, :] > 0.0, all_dep, -1.0)

    top_d, top_i = top_k_stable(all_dep.transpose(-1, -2), k)  # [..,P,k]
    ti = top_i.transpose(-1, -2)                               # [..,k,P]
    bb_pts = torch.gather(all_pts, -2, ti.unsqueeze(-3).expand(ti.shape[:-2] + (3,) + ti.shape[-2:]))
    bb_n = n_bb[..., :, None, :].expand(bb_pts.shape)
    bb_d = top_d.transpose(-1, -2)

    a_box = shape_a == SHAPE_BOX
    b_box = shape_b == SHAPE_BOX
    both_box = a_box & b_box
    a_sph_b_box = (~a_box) & b_box
    a_box_b_sph = a_box & (~b_box)

    slot0, not0 = _slot_masks(k, dev)

    def single_to_slots(pt, n, d):
        return pt[..., :, None, :] * slot0, n[..., :, None, :] * slot0, d[..., None, :] * slot0 - not0

    ss_pts, ss_ns, ss_ds = single_to_slots(ss_pt, ss_n, ss_d)
    sb_pts, sb_ns, sb_ds = single_to_slots(sb_pt, sb_n, sb_d)
    bs_pts, bs_ns, bs_ds = single_to_slots(bs_pt, bs_n, bs_d)

    c = P * k

    def flat(x):  # [.., k, P] / [.., 3, k, P] → [.., C], k-major
        return x.reshape(x.shape[:-2] + (c,))

    m_bb_c = both_box.tile((k,))
    m_sb_c = a_sph_b_box.tile((k,))
    m_bs_c = a_box_b_sph.tile((k,))

    def select(bb, sb, bs, ss, vec):
        m = (lambda x: x.unsqueeze(AX)) if vec else (lambda x: x)
        return torch.where(m(m_bb_c), flat(bb), torch.where(
            m(m_sb_c), flat(sb), torch.where(m(m_bs_c), flat(bs), flat(ss))))

    point = select(bb_pts, sb_pts, bs_pts, ss_pts, True)
    normal = select(bb_n, sb_ns, bs_ns, ss_ns, True)
    depth = select(bb_d, sb_ds, bs_ds, ss_ds, False)
    nlen = torch.sum(normal * normal, dim=AX)
    active = (depth > 0.0) & (nlen > 1e-6)
    return point, normal, depth, active


def concat_contacts(a: Contacts, b: Contacts) -> Contacts:
    """Concatenate two slot streams; static body columns are broadcast to
    the other stream's batch axes when one of them is per world."""
    def cat_idx(x, y):
        batch = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])
        return torch.cat([x.expand(batch + x.shape[-1:]), y.expand(batch + y.shape[-1:])], dim=-1)

    return Contacts(
        body_a=cat_idx(a.body_a, b.body_a),
        body_b=cat_idx(a.body_b, b.body_b),
        point=torch.cat([a.point, b.point], dim=-1),
        normal=torch.cat([a.normal, b.normal], dim=-1),
        depth=torch.cat([a.depth, b.depth], dim=-1),
        active=torch.cat([a.active, b.active], dim=-1),
    )


def orthonormal_tangents(n):
    """Two tangent directions per contact from normals [..., 3, C]."""
    nx, ny, nz = lm.unstack(n, AX)
    use_x = torch.abs(nx) < 0.9
    hx = torch.where(use_x, 1.0, 0.0)
    hy = torch.where(use_x, 0.0, 1.0)
    h = torch.stack([hx, hy, torch.zeros_like(hx)], dim=AX)
    t1 = lm.cross(n, h, axis=AX)
    t1 = t1 * torch.rsqrt(torch.clamp_min(torch.sum(t1 * t1, dim=AX, keepdim=True), 1e-12))
    t2 = lm.cross(n, t1, axis=AX)
    return t1, t2


def inv_inertia_world_diag(rot, inv_inertia_body):
    """World inverse inertia approximated as the diagonal
    diag(R · I⁻¹_body · Rᵀ) → [..., 3, NB]."""
    m = lm.quat_to_mat3(rot.transpose(-1, -2))        # [..,NB,3,3]
    ib = inv_inertia_body.transpose(-1, -2)           # [..,NB,3]
    diag = torch.sum(m * ib[..., None, :] * m, dim=-1)  # [..,NB,3]
    return diag.transpose(-1, -2)


def update_sleep(vel, angvel, sleep_counter, dyn_mask, lin_thresh: float = 0.03,
                 ang_thresh: float = 0.05, frames_to_sleep: int = 30):
    """Velocity-threshold sleeping: counts calm frames; asleep bodies get
    zeroed velocities."""
    calm = (torch.sum(vel * vel, dim=AX) < lin_thresh ** 2) & (
        torch.sum(angvel * angvel, dim=AX) < ang_thresh ** 2)
    counter = torch.where(calm & dyn_mask, sleep_counter + 1, 0).to(sleep_counter.dtype)
    asleep = counter >= frames_to_sleep
    v = torch.where(asleep[..., None, :], 0.0, vel)
    w = torch.where(asleep[..., None, :], 0.0, angvel)
    return v, w, counter, asleep
