"""Convex-hull narrowphase and SDF mesh-collider contacts on tensors
(counterpart of ``lumixengine_tpu/ops/convex_ops.py``; the hulls and grids
come from ``physics/cooking.py``).

Every shape that meets a hull takes part as a padded polytope: a fixed-size
local vertex set ``[3, V, N]`` and a support radius (a sphere is 1 vertex
plus its radius, a capsule 2 vertices plus its radius, a box its 8 corners,
a hull its cooked vertices), with a fixed-size set of unit face axes
``[3, F, N]``. Contacts come from SAT over both bodies' face axes and the
centre line; the manifold is the deepest ``k`` vertices of either polytope
against the other's support plane.

Mesh colliders are static bodies with a baked signed-distance grid; a
dynamic body meets one where its candidate points (its polytope vertices)
sample the grid below their support radius.

Where the reference selected with one-hot contractions (a TPU layout rule),
this port gathers by index; the values are the same. Batch axes lead.
"""
from __future__ import annotations

import torch

from lumixengine_tpu_torch.core import math as lm
from lumixengine_tpu_torch.ops.physics_ops import Contacts, top_k_stable


def _gather_cols(x, idx):
    """x [..., c, J, P] at idx [..., k, P] along J → [..., c, k, P]."""
    c = x.shape[-3]
    batch = torch.broadcast_shapes(x.shape[:-3], idx.shape[:-2])
    x = x.expand(batch + x.shape[-3:])
    idx = idx.expand(batch + idx.shape[-2:])
    return torch.gather(x, -2, idx.unsqueeze(-3).expand(batch + (c,) + idx.shape[-2:]))


def polytope_world_verts(pos, rot, verts_local):
    """verts_local [.., 3, V, N] → world [.., 3, V, N]."""
    return pos.unsqueeze(-2) + lm.quat_rotate(rot.unsqueeze(-2), verts_local, axis=-3)


def support_extent(verts_rel, u):
    """Largest extent of vertex offsets [.., 3, V, N] along unit axes
    u [.., 3, N] → [.., N] (the support function without the radius)."""
    return torch.amax(torch.sum(verts_rel * u.unsqueeze(-2), dim=-3), dim=-2)


def _dots(v, u):
    """v [.., 3, V, P] · u [.., 3, A, P] over the component axis → [.., V, A, P]."""
    return torch.einsum("...cvp,...cap->...vap", v, u)


def polytope_pair_contacts(pos, rot, verts, axes, rad, pair_a, pair_b,
                           points_per_pair: int = 4) -> Contacts:
    """Narrowphase over a pair list (int64 [P]) of padded polytopes:
    verts [3, V, NB] local, axes [3, F, NB] local unit face normals, rad
    [NB] support radii. C = points_per_pair · P slots, slot-major [k, P]."""
    k = points_per_pair
    point, normal, depth, active = polytope_pair_contacts_from_data(
        pos.index_select(-1, pair_a), rot.index_select(-1, pair_a), verts.index_select(-1, pair_a),
        axes.index_select(-1, pair_a), rad.index_select(-1, pair_a),
        pos.index_select(-1, pair_b), rot.index_select(-1, pair_b), verts.index_select(-1, pair_b),
        axes.index_select(-1, pair_b), rad.index_select(-1, pair_b), points_per_pair=k)
    return Contacts(body_a=pair_a.tile((k,)), body_b=pair_b.tile((k,)), point=point,
                    normal=normal, depth=depth, active=active)


def polytope_pair_contacts_from_data(pos_a, rot_a, va_l, fa_l, ra, pos_b, rot_b, vb_l, fb_l, rb,
                                     points_per_pair: int = 4):
    """SAT narrowphase on gathered padded-polytope pair data: va_l/vb_l
    [.., 3, V, P] local vertices, fa_l/fb_l [.., 3, F, P] local unit face
    axes, ra/rb [.., P] support radii → (point, normal, depth, active), each
    with C = k · P slots in slot-major [k, P] layout. The banded branch
    builds its partner views (physics_banded.banded_polytope_grids) and
    comes here directly."""
    k = points_per_pair
    va = lm.quat_rotate(rot_a.unsqueeze(-2), va_l, axis=-3)       # [..,3,V,P]
    vb = lm.quat_rotate(rot_b.unsqueeze(-2), vb_l, axis=-3)
    axa = lm.quat_rotate(rot_a.unsqueeze(-2), fa_l, axis=-3)      # [..,3,F,P]
    axb = lm.quat_rotate(rot_b.unsqueeze(-2), fb_l, axis=-3)
    d_ab = pos_b - pos_a                                          # [..,3,P]

    # candidate axes: A's faces, B's faces and the normalized centre line
    d_len = torch.sqrt(torch.clamp_min(torch.sum(d_ab * d_ab, dim=-2), 1e-12))
    d_axis = (d_ab / d_len.unsqueeze(-2)).unsqueeze(-2)           # [..,3,1,P]
    batch = torch.broadcast_shapes(axa.shape[:-3], axb.shape[:-3], d_axis.shape[:-3])
    cand = torch.cat([axa.expand(batch + axa.shape[-3:]), axb.expand(batch + axb.shape[-3:]),
                      d_axis.expand(batch + d_axis.shape[-3:])], dim=-2)  # [..,3,NA,P]

    # overlap(u) = E_A(u) + E_B(u) - |d·u|, E_X(u) = max_v(v·u) + r; padded
    # axes repeat real ones, so duplicates never win on their own
    du = torch.sum(d_ab.unsqueeze(-2) * cand, dim=-3)             # [..,NA,P]
    sgn = torch.where(du >= 0, 1.0, -1.0)
    u = cand * sgn.unsqueeze(-3)                                  # oriented a → b
    ea = torch.amax(_dots(va, u), dim=-3) + ra.unsqueeze(-2)
    eb = torch.amax(_dots(vb, -u), dim=-3) + rb.unsqueeze(-2)
    overlap = ea + eb - torch.abs(du)                             # [..,NA,P]

    best = torch.argmin(overlap, dim=-2)                          # [..,P], first of ties
    n = torch.gather(u, -2, best[..., None, None, :].expand(u.shape[:-2] + (1, u.shape[-1]))
                     ).squeeze(-2)                                # [..,3,P]
    min_overlap = torch.amin(overlap, dim=-2)

    # support planes along n: A's far face, B's near face
    sup_a = torch.sum(pos_a * n, dim=-2) + support_extent(va, n) + ra
    sup_b = torch.sum(pos_b * n, dim=-2) - (support_extent(vb, -n) + rb)

    # manifold: the deepest k of B's vertices behind A's face and of A's
    # beyond B's (face-face and vertex-face alike)
    pb_w = pos_b.unsqueeze(-2) + vb                               # [..,3,V,P]
    pa_w = pos_a.unsqueeze(-2) + va
    n_v = n.unsqueeze(-2)
    dep_b = sup_a.unsqueeze(-2) - torch.sum(pb_w * n_v, dim=-3) + rb.unsqueeze(-2)
    dep_a = torch.sum(pa_w * n_v, dim=-3) - sup_b.unsqueeze(-2) + ra.unsqueeze(-2)
    # contact points: the incident vertices pushed onto the body surface along n
    pts_b = pb_w - n_v * rb[..., None, None, :]
    pts_a = pa_w + n_v * ra[..., None, None, :]
    all_dep = torch.cat([dep_b, dep_a], dim=-2)                   # [..,2V,P]
    all_pts = torch.cat([pts_b, pts_a], dim=-2)                   # [..,3,2V,P]
    all_dep = torch.minimum(all_dep, min_overlap.unsqueeze(-2))
    all_dep = torch.where(min_overlap.unsqueeze(-2) > 0.0, all_dep, -1.0)

    top_d, top_i = top_k_stable(all_dep.transpose(-1, -2), k)     # [..,P,k]
    pts = _gather_cols(all_pts, top_i.transpose(-1, -2))          # [..,3,k,P]
    dep = top_d.transpose(-1, -2)                                 # [..,k,P]
    c = pts.shape[-1] * k
    point = pts.reshape(pts.shape[:-2] + (c,))
    depth = dep.reshape(dep.shape[:-2] + (c,))
    normal = n.unsqueeze(-2).expand(pts.shape).reshape(point.shape)
    return point, normal, depth, depth > 0.0


def _drop_y(pts, r):
    """pts [.., 3, J, M] with r [.., M] taken off the y row (the lowest point
    of a vertex's support sphere)."""
    return torch.stack([pts[..., 0, :, :], pts[..., 1, :, :] - r.unsqueeze(-2),
                        pts[..., 2, :, :]], dim=-3)


def _down_normals(point):
    normal = torch.zeros_like(point)
    normal[..., 1, :] = -1.0
    return normal


def polytope_ground_contacts(pos, rot, verts, rad, body_idx, ground_y: float,
                             points_per_body: int = 4) -> Contacts:
    """Ground-plane contacts for a subset of bodies as padded polytopes:
    body_idx int64 [M] actor slots, verts [3, V, M] local, rad [M]. The
    `points_per_body` deepest vertices of each; C = M · points_per_body."""
    k = points_per_body
    m = body_idx.shape[0]
    vw = polytope_world_verts(pos.index_select(-1, body_idx), rot.index_select(-1, body_idx),
                              verts)                              # [..,3,V,M]
    low = vw[..., 1, :, :] - rad.unsqueeze(-2)                    # [..,V,M]
    top_d, top_i = top_k_stable((ground_y - low).transpose(-1, -2), k)  # [..,M,k]
    pts = _drop_y(_gather_cols(vw, top_i.transpose(-1, -2)), rad)  # [..,3,k,M]
    dep = top_d.transpose(-1, -2)
    c = k * m
    point = pts.reshape(pts.shape[:-2] + (c,))
    depth = dep.reshape(dep.shape[:-2] + (c,))
    body_a = body_idx.tile((k,))
    return Contacts(body_a=body_a, body_b=torch.full_like(body_a, -1), point=point,
                    normal=_down_normals(point), depth=depth, active=depth > 0.0)


def polytope_ground_grids(pos, rot, pverts, prad, sel_mask, ground_y: float) -> Contacts:
    """Ground-plane contacts of every actor slot as a padded polytope, in the
    per-body stream layout [V blocks of NB] of physics_ops.ground_contacts
    (so the banded branch re-ranks it whole): every vertex is a slot;
    sel_mask [NB] says which bodies use this stream."""
    vw = polytope_world_verts(pos, rot, pverts)                   # [..,3,V,NB]
    nb, v = vw.shape[-1], vw.shape[-2]
    depth = ground_y - (vw[..., 1, :, :] - prad.unsqueeze(-2))    # [..,V,NB]
    pts = _drop_y(vw, prad)
    c = v * nb
    point = pts.reshape(pts.shape[:-2] + (c,))
    depth = depth.reshape(depth.shape[:-2] + (c,))
    body_a = torch.arange(nb, device=pos.device).tile((v,))
    return Contacts(body_a=body_a, body_b=torch.full_like(body_a, -1), point=point,
                    normal=_down_normals(point), depth=depth,
                    active=(depth > 0.0) & sel_mask.tile((v,)))


def raycast_convex(origin, direction, pos, rot, axes, lo, hi, mask):
    """Exact ray against convex hulls by slab clipping over their face axes
    (the F slabs' intersection is the hull; support intervals [lo, hi] take
    both sides of a deduplicated axis). origin/direction [.., 3]; pos
    [.., 3, NB]; rot [.., 4, NB]; axes [3, F, NB] local unit; lo/hi [F, NB];
    → (hit, t, idx)."""
    qinv = lm.quat_conjugate(rot, axis=-2)
    o_l = lm.quat_rotate(qinv, origin.unsqueeze(-1) - pos, axis=-2)   # [..,3,NB]
    d_l = lm.quat_rotate(qinv, direction.unsqueeze(-1).expand(o_l.shape), axis=-2)
    od = torch.sum(o_l.unsqueeze(-2) * axes, dim=-3)                  # [..,F,NB]
    dd = torch.sum(d_l.unsqueeze(-2) * axes, dim=-3)
    safe = torch.where(torch.abs(dd) < 1e-9, torch.where(dd >= 0, 1e-9, -1e-9), dd)
    t1 = (lo - od) / safe
    t2 = (hi - od) / safe
    tmin = torch.amax(torch.minimum(t1, t2), dim=-2)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-2)
    valid = (tmax >= torch.clamp_min(tmin, 0.0)) & mask
    t = torch.where(valid, torch.clamp_min(tmin, 0.0), torch.inf)
    tm, idx = torch.min(t, dim=-1)
    return torch.isfinite(tm), tm, idx.to(torch.int32)


# -- SDF mesh colliders ---------------------------------------------------------


def sdf_sample(grid, origin, cell: float, p):
    """Trilinear SDF sample at points p [.., 3, N] → [.., N]. A point outside
    the grid takes the border value plus its distance to the grid box, so
    that the space beyond the grid reads as far, not as the border."""
    nx, ny, nz = grid.shape
    q_raw = (p - origin.unsqueeze(-1)) / cell
    q = torch.stack([q_raw[..., a, :].clamp(0.0, n - 1.001) for a, n in enumerate((nx, ny, nz))],
                    dim=-2)
    outside = (q_raw - q) * cell
    extra = torch.sqrt(torch.clamp_min(torch.sum(outside * outside, dim=-2), 0.0))
    i0 = torch.floor(q).to(torch.int64)
    f = q - i0
    fx, fy, fz = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    ix, iy, iz = i0[..., 0, :], i0[..., 1, :], i0[..., 2, :]
    flat = grid.reshape(-1)

    def at(dx, dy, dz):
        return flat[((ix + dx) * ny + (iy + dy)) * nz + (iz + dz)]

    c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz + extra


def sdf_gradient(grid, origin, cell: float, p, eps_cells: float = 0.5):
    """Central-difference SDF gradient, normalized, at points p [.., 3, N]
    → [.., 3, N]."""
    e = eps_cells * cell
    grads = []
    for a in range(3):
        def moved(sign, _a=a):  # p with component a moved by sign * e
            return torch.cat([p[..., :_a, :], p[..., _a:_a + 1, :] + sign * e,
                              p[..., _a + 1:, :]], dim=-2)

        gp = sdf_sample(grid, origin, cell, moved(1.0))
        gm = sdf_sample(grid, origin, cell, moved(-1.0))
        grads.append((gp - gm) / (2.0 * e))
    gvec = torch.stack(grads, dim=-2)
    glen = torch.sqrt(torch.clamp_min(torch.sum(gvec * gvec, dim=-2), 1e-12))
    return gvec / glen.unsqueeze(-2)


def sdf_contacts(points, eff_radius, body_idx, grid, origin, cell: float, collider_pos,
                 collider_rot) -> Contacts:
    """Contacts of candidate points [.., 3, C] with one SDF mesh collider:
    eff_radius [C] the support radius at each point, body_idx int64 [C] the
    owning actor slots; the collider's pose [3], [4] takes the points into
    the mesh's space before sampling. body_b = -1 (static world)."""
    inv = lm.quat_conjugate(collider_rot, axis=-1).unsqueeze(-1)
    local = lm.quat_rotate(inv, points - collider_pos.unsqueeze(-1), axis=-2)
    d = sdf_sample(grid, origin, cell, local)
    n_l = sdf_gradient(grid, origin, cell, local)
    n_w = lm.quat_rotate(collider_rot.unsqueeze(-1), n_l, axis=-2)
    depth = eff_radius - d
    return Contacts(body_a=body_idx, body_b=torch.full_like(body_idx, -1), point=points,
                    normal=-n_w, depth=depth, active=depth > 0.0)
