"""Large-single-world rigid-body pipeline (counterpart of
``lumixengine_tpu/ops/physics_big.py``): the sweep-and-prune broadphase,
the PGS solve and the position projection on contact sets whose body
indices are data, the pair compaction, and the stand-alone world step
``make_big_world_step`` on them. The PhysicsModule's ``broadphase="sap"``
runs the first three.

  broadphase  — sort the bodies by AABB min-x, pair each with its next K
                in sorted order, prune by AABB overlap;
  narrowphase — physics_ops.pair_contacts on the gathered pair data;
  solver      — projected Jacobi, each body's impulses summed per body.

Every function takes leading world axes (``[..., 3, NB]``; pair and contact
rows ``[..., P]``). The reference sums each body's impulses with
``segment_sum`` (a scatter-add). Here the sum is a fixed-width gather: the
contacts are sorted by body once per step (``segment_plan``) into a table
of at most ``width`` contact slots a body, and each pass gathers and sums
that table. There is no atomic add, so a device repeats its results bit
for bit; the order of the adds differs from the reference's by rounding.
The caller gives the width, the most contacts a body can have in the
stream, from how the stream is built (``sap_pairs``: K pairs a body as
a, at most K as b).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from lumixengine_tpu_torch.core import math as lm
from lumixengine_tpu_torch.ops import physics_ops as P

AX = -2


def sap_pairs(pos, aabb_min, aabb_max, neighbors: int = 24, return_miss_count: bool = False):
    """Sweep-and-prune candidate pairs: sort by AABB min-x (stable), window
    of K successors → (pair_a int64 [..., N·K], pair_b int64 [..., N·K],
    overlap mask [..., N·K][, window_miss int32 [...]]).

    window_miss counts bodies whose x-extent still reaches the (K+1)-th
    successor's min-x: bodies that may have lost a pair to the window. 0
    proves the window wide enough this step."""
    n = pos.shape[-1]
    dev = pos.device
    order = torch.argsort(aabb_min[..., 0, :], dim=-1, stable=True)
    offs = torch.arange(1, neighbors + 1, device=dev).repeat(n)
    rank_a = torch.arange(n, device=dev).repeat_interleave(neighbors)
    rank_b = rank_a + offs
    valid = rank_b < n
    rank_b = torch.clamp_max(rank_b, n - 1)
    pa = order.index_select(-1, rank_a)
    pb = order.index_select(-1, rank_b)
    mn_a, mx_a = P.take_vecs(aabb_min, pa), P.take_vecs(aabb_max, pa)
    mn_b, mx_b = P.take_vecs(aabb_min, pb), P.take_vecs(aabb_max, pb)
    overlap = torch.all((mn_a <= mx_b) & (mn_b <= mx_a), dim=-2)
    ok = overlap & valid
    if not return_miss_count:
        return pa, pb, ok
    mx_sorted = torch.gather(aabb_max[..., 0, :], -1, order)
    mn_sorted = torch.gather(aabb_min[..., 0, :], -1, order)
    beyond = torch.arange(n, device=dev) + neighbors + 1
    in_range = beyond < n
    mn_beyond = mn_sorted.index_select(-1, torch.clamp_max(beyond, n - 1))
    miss = torch.sum((mx_sorted >= mn_beyond) & in_range, dim=-1).to(torch.int32)
    return pa, pb, ok, miss


class SegmentPlan(NamedTuple):
    """Each body's contact slots: table int64 [..., NB·width], slot indices
    sorted by body, C (a zero column) where a body has fewer."""

    table: torch.Tensor
    nb: int
    width: int


def segment_plan(idx, nb: int, width: int, keep=None) -> SegmentPlan:
    """The plan that sums contact rows into bodies idx [..., C] (int64):
    a stable sort by body, each slot's place in its body's run, and a
    scatter of the slot indices into [NB, width] rows (every target is
    written once). Slots with `keep` False are left out (they would add 0);
    a body's slots past `width` are dropped, so `width` must bound them."""
    c = idx.shape[-1]
    if keep is not None:
        idx = torch.where(keep, idx, nb)                 # the trash body
    perm = torch.argsort(idx, dim=-1, stable=True)
    body = torch.gather(idx, -1, perm)
    start = torch.searchsorted(body, torch.arange(nb + 1, device=idx.device).expand(
        idx.shape[:-1] + (nb + 1,)).contiguous())
    place = torch.arange(c, device=idx.device) - torch.gather(start, -1, body)
    ok = (body < nb) & (place < width)
    dest = torch.where(ok, body * width + place, nb * width)
    table = torch.full(idx.shape[:-1] + (nb * width + 1,), c, dtype=torch.int64,
                       device=idx.device)
    table.scatter_(-1, dest, perm)
    return SegmentPlan(table[..., :nb * width], nb, width)


def segment_sum(x, plan: SegmentPlan):
    """x [..., c, C] summed per body → [..., c, NB] (≙ segment_sum)."""
    xp = F.pad(x, (0, 1))
    g = P.take_vecs(xp, plan.table)
    return torch.sum(g.reshape(g.shape[:-1] + (plan.nb, plan.width)), dim=-1)


def contact_plans(body_a, body_b, has_b, nb: int, width_a: int, width_b: int):
    """The plans of the a and b sides of a contact stream: b-side slots
    without a body (has_b 0) are left out."""
    return (segment_plan(body_a, nb, width_a),
            segment_plan(body_b, nb, width_b, keep=has_b > 0))


def _degree(active, has_b, plans):
    act_f = active.to(torch.float32)
    return (segment_sum(act_f.unsqueeze(-2), plans[0])
            + segment_sum((act_f * has_b).unsqueeze(-2), plans[1])).squeeze(-2)


def solve_contacts_dynamic(pos, vel, angvel, inv_mass_arr, iiw, point, normal, depth, active,
                           body_a, body_b, has_b, friction, restitution, dt, plans,
                           iterations: int = 8, baumgarte: float = 0.2, slop: float = 0.005,
                           relaxation: float = 0.75):
    """PGS with data body indices body_a/body_b [..., C] (int64; has_b 0
    where b is the ground): per-contact gathers, per-body sums by `plans`
    (contact_plans). Relaxation is scaled per contact by the larger of its
    two bodies' active-contact degrees (Jacobi stability in dense piles)."""
    ba, bb = body_a, body_b
    im_a = P.take_rows(inv_mass_arr, ba)
    im_b = P.take_rows(inv_mass_arr, bb) * has_b
    deg = _degree(active, has_b, plans)
    deg_c = torch.clamp_min(torch.maximum(P.take_rows(deg, ba), P.take_rows(deg, bb) * has_b), 1.0)
    relaxation = torch.clamp_max(1.6 / deg_c, relaxation)

    n = normal
    t1, t2 = P.orthonormal_tangents(n)
    r_a = point - P.take_vecs(pos, ba)
    r_b = point - P.take_vecs(pos, bb)
    II_a = P.take_vecs(iiw, ba)
    II_b = P.take_vecs(iiw, bb) * has_b.unsqueeze(-2)

    def ang_term(r, d, II):
        rxd = lm.cross(r, d, axis=AX)
        return torch.sum(lm.cross(II * rxd, r, axis=AX) * d, dim=AX)

    k_n = torch.clamp_min(im_a + im_b + ang_term(r_a, n, II_a) + ang_term(r_b, n, II_b), 1e-9)
    k_t1 = torch.clamp_min(im_a + im_b + ang_term(r_a, t1, II_a) + ang_term(r_b, t1, II_b), 1e-9)
    k_t2 = torch.clamp_min(im_a + im_b + ang_term(r_a, t2, II_a) + ang_term(r_b, t2, II_b), 1e-9)
    bias = P.baumgarte_bias(baumgarte, dt, depth, slop)
    hb = has_b.unsqueeze(-2)

    def rel_vel(v, w):
        vw = torch.cat([v, w], dim=AX)
        a6, b6 = P.take_vecs(vw, ba), P.take_vecs(vw, bb)
        va = a6[..., 0:3, :] + lm.cross(a6[..., 3:6, :], r_a, axis=AX)
        vb = (b6[..., 0:3, :] + lm.cross(b6[..., 3:6, :], r_b, axis=AX)) * hb
        return vb - va

    vn0 = torch.sum(rel_vel(vel, angvel) * n, dim=AX)
    # restitution and the Baumgarte bias do not stack (the larger wins)
    v_target = torch.maximum(bias, torch.where(vn0 < -0.5, -restitution * vn0, 0.0))

    v, w = vel, angvel
    ln = torch.zeros_like(depth)
    lt1, lt2 = torch.zeros_like(depth), torch.zeros_like(depth)
    for _ in range(iterations):
        vr = rel_vel(v, w)
        vn = torch.sum(vr * n, dim=AX)
        dln = (v_target - vn) / k_n * relaxation
        new_ln = torch.clamp_min(ln + dln, 0.0)
        dln = torch.where(active, new_ln - ln, 0.0)
        vt1 = torch.sum(vr * t1, dim=AX)
        vt2 = torch.sum(vr * t2, dim=AX)
        max_f = friction * (ln + dln)
        new_lt1 = torch.clamp(lt1 + (-vt1 / k_t1) * relaxation, -max_f, max_f)
        new_lt2 = torch.clamp(lt2 + (-vt2 / k_t2) * relaxation, -max_f, max_f)
        dlt1 = torch.where(active, new_lt1 - lt1, 0.0)
        dlt2 = torch.where(active, new_lt2 - lt2, 0.0)
        imp = n * dln.unsqueeze(-2) + t1 * dlt1.unsqueeze(-2) + t2 * dlt2.unsqueeze(-2)
        six_a = torch.cat([imp, lm.cross(r_a, imp, axis=AX)], dim=AX)
        six_b = torch.cat([imp * hb, lm.cross(r_b, imp, axis=AX) * hb], dim=AX)
        acc = segment_sum(six_b, plans[1]) - segment_sum(six_a, plans[0])
        v = v + acc[..., 0:3, :] * inv_mass_arr.unsqueeze(-2)
        w = w + acc[..., 3:6, :] * iiw
        ln, lt1, lt2 = ln + dln, lt1 + dlt1, lt2 + dlt2
    return v, w


def project_positions_dynamic(pos, normal, depth, active, body_a, body_b, has_b, inv_mass_arr,
                              plans, iterations: int = 3, slop: float = 0.005,
                              relaxation: float = 0.8):
    """Split-impulse position projection with data body indices: the
    counterpart of the static-pair projection, each body's push capped at
    5 cm a frame."""
    im_a = P.take_rows(inv_mass_arr, body_a)
    im_b = P.take_rows(inv_mass_arr, body_b) * has_b
    k_lin = torch.clamp_min(im_a + im_b, 1e-9)
    e0 = torch.where(active, torch.clamp(depth - slop, 0.0, 0.05), 0.0)
    deg = _degree(active, has_b, plans)
    deg_c = torch.clamp_min(torch.maximum(P.take_rows(deg, body_a),
                                          P.take_rows(deg, body_b) * has_b), 1.0)
    relax_c = torch.clamp_max(1.6 / deg_c, relaxation)
    hb = has_b.unsqueeze(-2)

    dpos = torch.zeros_like(pos)
    lam = torch.zeros_like(e0)
    for _ in range(iterations):
        da = P.take_vecs(dpos, body_a)
        db = P.take_vecs(dpos, body_b) * hb
        sep = torch.sum((db - da) * normal, dim=AX)
        dlam = (e0 - sep) / k_lin * relax_c
        new_lam = torch.clamp_min(lam + dlam, 0.0)
        # mask after the max: inactive slots may carry degenerate normals
        dlam = torch.where(active, new_lam - lam, 0.0)
        step_vec = normal * dlam.unsqueeze(-2)
        dpos = dpos + (segment_sum(step_vec * hb, plans[1])
                       - segment_sum(step_vec, plans[0])) * inv_mass_arr.unsqueeze(-2)
        lam = new_lam
    return pos + dpos


def compact_pairs(pa: torch.Tensor, pb: torch.Tensor, ok: torch.Tensor, budget: int):
    """Stable compaction of the overlapping candidates into a fixed budget:
    the overlapping pairs in ascending index, then the others in ascending
    index, cut at the budget (the reference's top_k order; the warm-start
    gate keys on it). The reference packs the pair ids into a top_k key, a
    TPU layout trick; here it is a prefix sum.

    pa, pb: int64 [P] (static) or [..., P] (per world); ok: bool [..., P].
    Returns (pa_c, pb_c int32 [..., budget], valid bool [..., budget] = the
    slot holds an overlapping pair, overflow int32 [...] = max(#ok − budget, 0)).
    """
    p = ok.shape[-1]
    oki = ok.to(torch.int64)
    n_ok = oki.sum(dim=-1, keepdim=True)
    rank_ok = torch.cumsum(oki, dim=-1) - 1
    rank_no = n_ok + torch.cumsum(1 - oki, dim=-1) - 1
    dest = torch.where(ok, rank_ok, rank_no)          # candidate -> slot
    iota = torch.arange(p, device=ok.device).expand(ok.shape)
    order = torch.empty_like(dest).scatter_(-1, dest, iota)  # slot -> candidate
    idx = order[..., :budget]
    valid = torch.arange(budget, device=ok.device) < n_ok
    overflow = torch.clamp_min(n_ok.squeeze(-1) - budget, 0).to(torch.int32)
    return (P.take_rows(pa, idx).to(torch.int32), P.take_rows(pb, idx).to(torch.int32), valid,
            overflow)


def make_big_world_step(shape_np: np.ndarray, radius_np, half_extents_np, dyn_mask_np,
                        inv_mass_np, inv_inertia_body_np, friction_np, restitution_np,
                        gravity=(0.0, -9.81, 0.0), neighbors: int = 24,
                        points_per_pair: int = 4, iterations: int = 8,
                        position_iterations: int = 3, ground_y: float = 0.0,
                        lin_damping: float = 0.05, ang_damping: float = 0.05,
                        ground_friction: float = 0.6, pair_budget: int | None = None):
    """The stand-alone step of one large world (leading world axes allowed):
    step(pos, rot, vel, angvel, dt) → (pos, rot, vel, angvel, counters),
    counters {active_contacts, sap_window_miss} int32 [...]. The tables
    move to the state's device on first use."""
    nb = shape_np.shape[0]
    k, gslots, K = points_per_pair, 4, neighbors
    any_caps = bool(np.any(np.asarray(shape_np) == P.SHAPE_CAPSULE))
    tables = dict(shape=(shape_np, torch.int64), radius=(radius_np, torch.float32),
                  he=(half_extents_np, torch.float32), dyn=(dyn_mask_np, torch.bool),
                  inv_mass=(inv_mass_np, torch.float32),
                  iib=(inv_inertia_body_np, torch.float32), fric=(friction_np, torch.float32),
                  rest=(restitution_np, torch.float32), gravity=(gravity, torch.float32))

    @functools.lru_cache(maxsize=None)
    def on(device):
        return {name: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
                for name, (a, dt) in tables.items()}

    def step(pos, rot, vel, angvel, dt):
        t = on(pos.device)
        batch = pos.shape[:-2]
        vel, angvel = P.integrate_velocities(vel, angvel, dt, t["gravity"], lin_damping,
                                             ang_damping, t["dyn"])
        # broadphase (window_miss > 0: raise `neighbors`)
        mn, mx = P.world_aabb(pos, rot, t["shape"], t["radius"], t["he"])
        pa, pb, ok, miss = sap_pairs(pos, mn, mx, K, return_miss_count=True)
        budget = pair_budget or min(8 * nb, pa.shape[-1])
        pa, pb, ok, overflow = compact_pairs(pa, pb, ok, budget)
        pa, pb = pa.to(torch.int64), pb.to(torch.int64)
        miss = miss + overflow
        c = P.pair_contacts(pos, rot, t["shape"], t["radius"], t["he"], pa, pb,
                            points_per_pair=k, any_caps=any_caps)
        pair_active = c.active & ok.tile((k,))
        fric, rest = t["fric"], t["rest"]
        pair_fric = torch.sqrt(P.take_rows(fric, c.body_a) * P.take_rows(fric, c.body_b))
        pair_rest = torch.maximum(P.take_rows(rest, c.body_a), P.take_rows(rest, c.body_b))
        g = P.ground_contacts(pos, rot, t["shape"], t["radius"], t["he"], t["dyn"],
                              ground_y=ground_y, slots_per_body=gslots)
        gnd_fric = torch.sqrt(fric[g.body_a] * ground_friction)
        gnd_rest = rest[g.body_a]

        def cat(x, y):
            return torch.cat([x.expand(y.shape[:-1] + x.shape[-1:]), y], dim=-1)

        point = torch.cat([g.point, c.point], dim=-1)
        normal = torch.cat([g.normal, c.normal], dim=-1)
        depth = torch.cat([g.depth, c.depth], dim=-1)
        active = torch.cat([g.active, pair_active], dim=-1)
        body_a = cat(g.body_a, c.body_a)
        body_b = cat(torch.zeros_like(g.body_a), c.body_b)
        has_b = torch.cat([torch.zeros(gslots * nb, device=pos.device),
                           torch.ones(c.body_a.shape[-1], device=pos.device)])
        cfric = cat(gnd_fric, pair_fric)
        crest = cat(gnd_rest, pair_rest)
        # a body is a of its gslots ground slots and of at most K pairs, b of at most K
        plans = contact_plans(body_a, body_b, has_b, nb, gslots + K * k, K * k)

        iiw = P.inv_inertia_world_diag(rot, t["iib"])
        vel, angvel = solve_contacts_dynamic(
            pos, vel, angvel, t["inv_mass"], iiw, point, normal, depth, active, body_a, body_b,
            has_b, cfric, crest, dt, plans, iterations=iterations,
            baumgarte=0.0)   # the position projection below owns depth correction
        pos, rot = P.integrate_positions(pos, rot, vel, angvel, dt, t["dyn"])
        pos = project_positions_dynamic(pos, normal, depth, active, body_a, body_b, has_b,
                                        t["inv_mass"], plans, iterations=position_iterations)
        counters = {"active_contacts": torch.sum(active, dim=-1).to(torch.int32),
                    "sap_window_miss": miss.expand(batch)}
        return pos, rot, vel, angvel, counters

    return step
