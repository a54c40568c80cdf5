"""Slot-compacted symmetric-pair rigid-body pipeline (counterpart of
``lumixengine_tpu/ops/physics_slots.py``): the large-pile path of the
10k-box drop.

  1. 4-offset column sweeps (``physics_banded.sweep_orders``) find directed
     AABB-overlap candidates on banded ``[W, NB]`` grids; a 6-face-axis SAT
     bound prunes box pairs that cannot touch.
  2. Candidates compact to P slots per body, deepest overlap first, by one
     int32 sort of packed (inverted priority | partner id) keys. Each
     undirected pair sits in BOTH bodies' slot lists.
  3. The narrowphase runs once on the P·NB directed pairs; partner poses
     arrive by one gather from a ``[18, NB]`` table.
  4. A Jacobi velocity solve and split-impulse position passes on ``[k, P,
     NB]`` slot grids: per iteration one gather of partner velocities, and
     no scatter — each body sums the impulses of its OWN slots, and its
     partner applies the opposite impulse from the mirrored slot.

SYMMETRY: every per-pair quantity is computed elementwise in CANONICAL
operand order (the smaller body id first) from the same values on both
directed copies, so both compute bitwise-identical Δλ and a zero-gravity
collision conserves momentum exactly. Nothing reduces over the slot axis
before the per-slot sign is applied.

CERTIFICATES: ``slot_drop`` counts compaction-dropped candidates whose
penetration bound exceeds the slop; ``column_miss`` counts bodies whose
same-column window might have been too narrow. Both zero ⇒ the step's
contact set was complete.

Layout: single world, ``pos [3, NB]``, ``rot [4, NB]``; the step holds no
host sync (no ``.item()``, no branch on a device value), so a caller may run
many steps and read the certificates once.
"""
from __future__ import annotations

import numpy as np
import torch

from lumixengine_tpu_torch.core import math as lm
from lumixengine_tpu_torch.ops import physics_banded as PBD
from lumixengine_tpu_torch.ops import physics_ops as P

I32 = torch.int32


def _back_fill(x, d: int, fill):
    """out[..., i+d] = x[..., i], head filled with `fill`."""
    d = min(d, x.shape[-1])
    if d == 0:
        return x
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def _gather_rows(table, idx):
    """One index gather of body columns: table [C, NB], idx int64 [P, NB] →
    [C, P, NB]."""
    return table.index_select(-1, idx.reshape(-1)).reshape(table.shape[:-1] + idx.shape)


def build_slots(mn, mx, occ, dyn, n_sweeps: int, window: int, slots: int,
                slop: float = 0.005, sat_prune=None):
    """Candidate discovery + compaction (single world, [3, NB] AABBs).

    sat_prune: optional (pos [3,NB], rot [4,NB], he [3,NB], is_box [NB]) —
    box-box candidates are then scored by the 6-face-axis SAT penetration
    bound (an upper bound on true penetration) instead of the AABB overlap.

    Returns (partner int32 [P, NB] body ids, -1 = empty; {"slot_drop",
    "column_miss", "max_candidates"} int32 scalars). Only the four column
    sweeps of the published tier are ported (n_sweeps = 4)."""
    if n_sweeps != 4:
        raise NotImplementedError("build_slots is ported for the 4 column sweeps only")
    nb = mn.shape[-1]
    dev = mn.device
    orders, ranks, col_keys = PBD.sweep_orders(mn, mx, occ, n_sweeps)
    W = window
    id_bits = max(int(np.ceil(np.log2(nb + 1))), 1)
    pri_bits = min(16, 30 - id_bits)
    if pri_bits < 8:
        raise ValueError(f"{nb} bodies overflow the packed slot sort")
    pri_max = (1 << pri_bits) - 1
    pri_scale = float(pri_max) / 8.0       # depth quantized over 0..8 m
    slop_q = max(int(np.floor(slop * pri_scale)), 1)
    id_mask = (1 << id_bits) - 1
    invalid = (pri_max << id_bits) | id_mask   # depth 0, sorts last

    fpack = [mn, mx]
    flags = dyn.to(I32) | (occ.to(I32) << 1)
    if sat_prune is not None:
        sp_pos, sp_rot, sp_he, sp_isbox = sat_prune
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        cols = torch.cat([lm.quat_rotate(sp_rot, eye[:, m, None].expand(3, nb), axis=0)
                          for m in range(3)], dim=0)            # face axes [9, NB]
        fpack += [sp_pos, cols, sp_he]
        flags = flags | (sp_isbox.to(I32) << 2)
    fcat = torch.cat(fpack, dim=0)                               # [CF, NB]

    def skew_rev(pk):
        """out[d-1, i+d] = pk[d-1, i], invalid-filled: a flat-reshape skew."""
        S = nb + W + 1
        a = torch.cat([pk, torch.full((W, S - nb), invalid, dtype=I32, device=dev)], dim=1)
        b = a.reshape(-1)[:W * (S - 1)].reshape(W, S - 1)
        return torch.cat([torch.full((W, 1), invalid, dtype=I32, device=dev), b], dim=1)[:, :nb]

    valid_rank = (torch.arange(1, W + 1, device=dev)[:, None]
                  + torch.arange(nb, device=dev)[None, :]) < nb
    rank_all = torch.stack(ranks)                                # [S, NB] int32

    def sweep_cand(s):
        """Sweep s's candidate block in BODY order ([2W, NB] packed int32)
        and its coverage-miss count. Pairs inside an EARLIER sweep's window
        were claimed there."""
        order, col_key = orders[s], col_keys[s]
        f_r = fcat.index_select(-1, order)
        i_r = torch.cat([order.to(I32)[None], flags.index_select(-1, order)[None],
                         rank_all[:s].index_select(-1, order)])  # [2+s, NB]
        fb = PBD.banded_pair_data(f_r, W)                        # [CF, W, NB]
        ib = PBD.banded_pair_data(i_r, W)                        # [2+s, W, NB]
        s_mn, s_mx, bmn, bmx = f_r[0:3], f_r[3:6], fb[0:3], fb[3:6]
        # minimum per-axis overlap — upper-bounds contact penetration
        ov_amt = torch.amin(torch.minimum(s_mx[:, None, :], bmx)
                            - torch.maximum(s_mn[:, None, :], bmn), dim=0)
        if sat_prune is not None:
            s_pos, s_cols, s_he = f_r[6:9], f_r[9:18], f_r[18:21]
            b_pos, b_cols, b_he = fb[6:9], fb[9:18], fb[18:21]
            diff = b_pos - s_pos[:, None, :]                     # a → b, [3, W, NB]
            pen = None
            for side in range(2):                                # axes of a, then of b
                own_he = s_he[:, None, :] if side == 0 else b_he
                oth_cols = b_cols if side == 0 else s_cols[:, None, :]
                oth_he = b_he if side == 0 else s_he[:, None, :]
                for m in range(3):
                    L = s_cols[3 * m:3 * m + 3][:, None, :] if side == 0 else b_cols[3 * m:3 * m + 3]
                    dist = torch.abs(torch.sum(diff * L, dim=0))
                    proj = own_he[m] + sum(
                        oth_he[j] * torch.abs(torch.sum(oth_cols[3 * j:3 * j + 3] * L, dim=0))
                        for j in range(3))
                    pen = proj - dist if pen is None else torch.minimum(pen, proj - dist)
            both_box = ((i_r[1] & 4)[None, :] & (ib[1] & 4)) != 0
            ov_amt = torch.where(both_box, torch.minimum(ov_amt, pen), ov_amt)
        either_dyn = ((i_r[1] & 1)[None, :] | (ib[1] & 1)) != 0
        both_occ = ((i_r[1] & 2)[None, :] & (ib[1] & 2)) != 0
        ov = (ov_amt > 0.0) & valid_rank & either_dyn & both_occ
        if s:   # cross-sweep dedup: pair already inside an earlier sweep's window
            ov = ov & ~torch.any(torch.abs(ib[2:] - i_r[2:, None, :]) <= W, dim=0)
        miss = PBD.column_window_miss(s_mn, s_mx, col_key.index_select(-1, order), W,
                                      occ=(i_r[1] & 2) != 0)
        inv_pri = (pri_max - torch.clamp(ov_amt * pri_scale, 0, pri_max).to(I32)) << id_bits
        pk_fwd = torch.where(ov, inv_pri | ib[0], invalid)
        pk_rev = skew_rev(torch.where(ov, inv_pri | i_r[0][None, :], invalid))
        cand = torch.cat([pk_fwd, pk_rev], dim=0)                # [2W, NB], rank order
        # rank order → body order: body i's column is rank ranks[s][i]
        return cand.index_select(1, ranks[s].to(torch.int64)), miss

    rows, misses = zip(*(sweep_cand(s) for s in range(len(orders))))
    column_miss = torch.sum(torch.stack(misses)).to(I32)
    cand_all = torch.cat(rows, dim=0)                            # [2·sweeps·W, NB]
    srt = torch.sort(cand_all, dim=0).values                     # deepest first
    top = srt[:slots]
    top_id = top & id_mask
    top_valid = top != invalid
    # duplicate safety net (cross-sweep dedup already ran; this keeps the
    # solver sound even for pathological wrap-around column collisions)
    eq = (top_id[:, None, :] == top_id[None, :, :]) & top_valid[None]
    lower = torch.arange(slots, device=dev)[:, None] > torch.arange(slots, device=dev)[None, :]
    top_valid = top_valid & ~torch.any(eq & lower[:, :, None], dim=1)
    partner = torch.where(top_valid, top_id, -1)
    # drop certificate: candidates beyond the P deepest whose quantized
    # penetration bound reaches slop (possible real contacts lost)
    rest = srt[slots:]
    dropped = torch.sum(((pri_max - (rest >> id_bits)) >= slop_q) & (rest != invalid)).to(I32)
    n_cand = torch.sum(cand_all != invalid, dim=0)
    return partner, {"slot_drop": dropped, "column_miss": column_miss,
                     "max_candidates": torch.max(n_cand).to(I32)}


def make_slot_world_step(
    shape_np: np.ndarray, radius_np, half_extents_np, dyn_mask_np,
    inv_mass_np, inv_inertia_body_np, friction_np, restitution_np,
    gravity=(0.0, -9.81, 0.0), slots: int = 16, window: int = 48,
    points_per_pair: int = 4, iterations: int = 8,
    position_iterations: int = 3, ground_y: float = 0.0,
    lin_damping: float = 0.05, ang_damping: float = 0.05,
    ground_friction: float = 0.6, n_sweeps: int = 4, slop: float = 0.005,
    warm_start: bool = True, mass_split: bool = True,
    sleeping: bool = True, sleep_speed: float = 0.08,
    sleep_frames: int = 30, wake_speed: float = 0.25,
    over_relax: float = 1.0, settle_damping: float = 0.0,
    max_correction: float = 0.04,
):
    """step(pos, rot, vel, angvel, dt, carry, consts) →
    (pos, rot, vel, angvel, counters, carry'), single world ([3|4, NB]).
    `consts = step.init_consts(device)` holds the body tables on the device;
    `step.init_carry(device)` is the cold carry, the reference's 6-tuple:
    (λ [3, k, P, NB] f32, partner ids [P, NB] int32, ground λ [3, 4, NB] f32,
    calm-frame counters [NB] int32, delayed wake [NB] bool, deep-ground flag
    [NB] bool).

    Only the reference's published tier is ported: 4 column sweeps, warm
    start, sleeping and mass splitting (Jacobi with contact-count-scaled
    effective masses im_i·n_i and the full Δλ, over-relaxed by over_relax).
    The classic tier (n_sweeps, warm_start, mass_split or sleeping off)
    raises NotImplementedError. A body calm (|v|²+|w|² < sleep_speed²) for
    sleep_frames frames, and not deep in the ground, sleeps — zero velocity,
    no gravity, static to the solver — and wakes one frame after an active
    partner moves faster than wake_speed. settle_damping bleeds supported
    slow bodies; max_correction caps the per-frame positional push."""
    if n_sweeps != 4 or not (warm_start and mass_split and sleeping):
        raise NotImplementedError("the slot step is ported at the published tier only "
                                  "(n_sweeps=4, warm_start, mass_split, sleeping)")
    nb = int(shape_np.shape[0])
    k = points_per_pair
    Pn = slots
    gslots = 4
    c_np = {
        "shape": np.asarray(shape_np, np.int32),
        "radius": np.asarray(radius_np, np.float32),
        "he": np.asarray(half_extents_np, np.float32),
        "dyn": np.asarray(dyn_mask_np, bool),
        "im": np.asarray(inv_mass_np, np.float32),
        "iib": np.asarray(inv_inertia_body_np, np.float32),
        "fric": np.asarray(friction_np, np.float32),
        "rest": np.asarray(restitution_np, np.float32),
        "gravity": np.asarray(gravity, np.float32),
    }
    # decided on the host from the shape table: they pick code paths
    any_caps = bool(np.any(c_np["shape"] == P.SHAPE_CAPSULE))
    any_box = bool(np.any(c_np["shape"] == P.SHAPE_BOX))

    def init_consts(device):
        return {name: torch.as_tensor(a, device=device) for name, a in c_np.items()}

    def init_carry(device):
        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        return (z((3, k, Pn, nb), torch.float32),
                torch.full((Pn, nb), -1, dtype=I32, device=device),
                z((3, gslots, nb), torch.float32), z(nb, I32), z(nb, torch.bool),
                z(nb, torch.bool))

    def step(pos, rot, vel, angvel, dt, carry, consts):
        shape_j, radius_j, he_j = consts["shape"], consts["radius"], consts["he"]
        dyn_j, im_j, iib_j = consts["dyn"], consts["im"], consts["iib"]
        fric_j, rest_j = consts["fric"], consts["rest"]
        dev = pos.device
        dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
        occ_j = torch.ones(nb, dtype=torch.bool, device=dev)
        iota = torch.arange(nb, dtype=I32, device=dev)
        prev_lam, prev_id, prev_glam, prev_ctr, prev_wake, prev_deep = carry

        # ---- sleeping: calm-streak counters + one-frame-delayed wake ------
        speed2_raw = torch.sum(vel * vel, 0) + torch.sum(angvel * angvel, 0)
        # a body may not doze off while deep in the ground (asleep ⇒
        # im_eff = 0 ⇒ the position pass could not push it out)
        calm = (speed2_raw < sleep_speed * sleep_speed) & dyn_j & ~prev_deep
        sleep_ctr = torch.where(calm, torch.clamp_max(prev_ctr + 1, sleep_frames), 0)
        asleep = (sleep_ctr >= sleep_frames) & ~prev_wake
        # partners that are themselves asleep (or static) never wake
        wake_sig = torch.where(asleep | ~dyn_j, 0.0, speed2_raw)
        im_eff = torch.where(asleep, 0.0, im_j)

        vel, angvel = P.integrate_velocities(vel, angvel, dt, consts["gravity"],
                                             lin_damping, ang_damping, dyn_j)
        # asleep = static for this frame: no gravity, no drift
        vel = torch.where(asleep[None], 0.0, vel)
        angvel = torch.where(asleep[None], 0.0, angvel)
        mn, mx = P.world_aabb(pos, rot, shape_j, radius_j, he_j)
        sat = (pos, rot, he_j, shape_j == P.SHAPE_BOX) if any_box else None
        partner, certs = build_slots(mn, mx, occ_j, dyn_j, n_sweeps, window, Pn,
                                     slop=slop, sat_prune=sat)
        pvalid = partner >= 0
        pidx = torch.clamp_min(partner, 0).to(torch.int64)

        # ---- one static-geometry/pose gather for the narrowphase ---------
        # (iiw zeroed for static AND sleeping bodies: neither may gather
        # phantom angular velocity from contact impulses)
        iiw = torch.where((dyn_j & ~asleep)[None], P.inv_inertia_world_diag(rot, iib_j), 0.0)
        table = torch.cat([pos, rot, radius_j[None], he_j, shape_j.to(torch.float32)[None],
                           im_eff[None], iiw, fric_j[None], rest_j[None]], dim=0)  # [18, NB]
        g18 = _gather_rows(table, pidx)                          # [18, P, NB]
        o_pos, o_rot = g18[0:3], g18[3:7]
        o_rad, o_he = g18[7], g18[8:11]
        o_shape = g18[11].to(I32)
        o_im, o_iiw = g18[12], g18[13:16]
        o_fric, o_rest = g18[16], g18[17]

        # ---- canonical (lo, hi) operand order: smaller body id first -----
        is_lo = iota[None, :] < partner                          # self is lo

        def pick(self_x, other_x):                               # [NB] + [P, NB]
            return torch.where(is_lo, self_x[None], other_x), \
                torch.where(is_lo, other_x, self_x[None])

        def sel3(self_x, other_x):                               # [c, NB] + [c, P, NB]
            s = self_x[:, None, :]
            return torch.where(is_lo[None], s, other_x), torch.where(is_lo[None], other_x, s)

        lo_pos, hi_pos = sel3(pos, o_pos)
        lo_rot, hi_rot = sel3(rot, o_rot)
        lo_rad, hi_rad = pick(radius_j, o_rad)
        lo_he, hi_he = sel3(he_j, o_he)
        lo_shape, hi_shape = pick(shape_j, o_shape)

        def flat(x):
            return x.reshape(x.shape[:-2] + (Pn * nb,))

        point, normal, depth, raw_act = P.pair_contacts_from_data(
            flat(lo_pos), flat(lo_rot), flat(lo_rad), flat(lo_he), flat(lo_shape),
            flat(hi_pos), flat(hi_rot), flat(hi_rad), flat(hi_he), flat(hi_shape),
            points_per_pair=k, any_caps=any_caps)

        def grid(x):
            return x.reshape(x.shape[:-1] + (k, Pn, nb))

        point, normal = grid(point), grid(normal)               # [3, k, P, NB]
        depth = grid(depth)                                      # [k, P, NB]
        active = grid(raw_act) & pvalid[None]

        # ---- canonical per-slot solver constants --------------------------
        lo_im, hi_im = pick(im_eff, o_im)
        lo_iiw, hi_iiw = sel3(iiw, o_iiw)
        fric_pair = torch.sqrt(torch.clamp_min(fric_j[None] * o_fric, 0.0))
        rest_pair = torch.maximum(rest_j[None], o_rest)

        r_lo = point - lo_pos[:, None]                           # [3, k, P, NB]
        r_hi = point - hi_pos[:, None]
        t1, t2 = PBD._tangents0(normal)
        # ---- ground contacts: body-major grids, no gathers ----------------
        g = P.ground_contacts(pos, rot, shape_j, radius_j, he_j, dyn_j,
                              ground_y=ground_y, slots_per_body=gslots, any_caps=any_caps)
        g_point = g.point.reshape(3, gslots, nb)
        g_normal = g.normal.reshape(3, gslots, nb)
        g_depth = g.depth.reshape(gslots, nb)
        g_active = g.active.reshape(gslots, nb)
        g_fric = torch.sqrt(torch.clamp_min(fric_j * ground_friction, 0.0))[None]
        g_r = g_point - pos[:, None, :]
        g_t1, g_t2 = PBD._tangents0(g_normal)

        # ---- per-body contact-point count (mass splitting / Jacobi) -------
        deg = (torch.sum(active, dim=(0, 1)) + torch.sum(g_active, dim=0)).to(torch.float32)
        sign = torch.where(is_lo, 1.0, -1.0)                     # +1: self is lo

        def partner_vw(v, w):
            # rows 6-7 carry the partner's contact count and raw-speed wake
            # signal: wake detection rides the velocity gather
            gvw = _gather_rows(torch.cat([v, w, deg[None], wake_sig[None]], dim=0), pidx)
            return gvw[0:3], gvw[3:6], gvw[6], gvw[7]

        def rel_vel(v, w, pv, pw):
            """Canonical relative velocity at each manifold point:
            (v_hi + w_hi × r_hi) − (v_lo + w_lo × r_lo), bitwise the same
            on both directed copies."""
            lo_v, hi_v = sel3(v, pv)
            lo_w, hi_w = sel3(w, pw)
            va = lo_v[:, None] + lm.cross(lo_w[:, None].expand(r_lo.shape), r_lo, axis=0)
            vb = hi_v[:, None] + lm.cross(hi_w[:, None].expand(r_hi.shape), r_hi, axis=0)
            return vb - va                                       # [3, k, P, NB]

        pv0, pw0, p_deg, p_wake = partner_vw(vel, angvel)
        # delayed wake for NEXT frame: an active slot partner moving faster
        # than wake_speed wakes this body (raw pre-step speeds)
        slot_touch = torch.any(active, dim=0)                    # [P, NB]
        wake_next = torch.any(slot_touch & (p_wake > wake_speed * wake_speed), dim=0)
        # deep-GROUND flag for NEXT frame's sleep-entry gate (8·slop = 4 cm,
        # between rest depth and the frozen-while-depenetrating depth)
        deep_next = torch.amax(torch.where(g_active, g_depth, 0.0), dim=0) > 8.0 * slop

        II_lo, II_hi = lo_iiw[:, None], hi_iiw[:, None]
        # mass splitting: each body's mass scaled by its contact count
        lo_deg, hi_deg = pick(deg, p_deg)
        s_lo = torch.clamp_min(lo_deg, 1.0)[None]                # [1, P, NB]
        s_hi = torch.clamp_min(hi_deg, 1.0)[None]
        relax = g_relax = over_relax
        g_split = torch.clamp_min(deg, 1.0)[None]                # [1, NB]
        im_lo_c, im_hi_c = (lo_im * s_lo[0])[None], (hi_im * s_hi[0])[None]

        def k_eff(d):
            return torch.clamp_min(im_lo_c + im_hi_c + s_lo * PBD._ang0(r_lo, d, II_lo)
                                   + s_hi * PBD._ang0(r_hi, d, II_hi), 1e-9)

        kn, kt1, kt2 = k_eff(normal), k_eff(t1), k_eff(t2)
        imn = im_eff[None]

        def g_k_eff(d):
            return torch.clamp_min(g_split * (imn + PBD._ang0(g_r, d, iiw[:, None])), 1e-9)

        g_kn, g_kt1, g_kt2 = g_k_eff(g_normal), g_k_eff(g_t1), g_k_eff(g_t2)

        vr0 = rel_vel(vel, angvel, pv0, pw0)
        vn0 = torch.sum(vr0 * normal, dim=0)
        target = torch.where(vn0 < -0.5, -rest_pair[None] * vn0, 0.0)
        g_va0 = vel[:, None] + lm.cross(angvel[:, None].expand(g_r.shape), g_r, axis=0)
        g_vn0 = torch.sum(-g_va0 * g_normal, dim=0)
        g_target = torch.where(g_vn0 < -0.5, -rest_j[None] * g_vn0, 0.0)

        r_self = torch.where(is_lo[None, None], r_lo, r_hi)

        def body_impulse(imp, g_imp):
            """Σ over own slots of −sign·(imp, r × imp) (sign applied per
            slot, before the reduction) minus the ground's (imp, r × imp)."""
            six = torch.cat([imp, lm.cross(r_self, imp, axis=0)], dim=0)
            acc = torch.sum(-sign[None, None] * six, dim=(1, 2))
            six_g = torch.cat([g_imp, lm.cross(g_r, g_imp, axis=0)], dim=0)
            return acc - torch.sum(six_g, dim=1)

        # ---- warm start: match canonical λ by partner id -------------------
        # prev_id rows hold UNIQUE partner ids per body (duplicates were -1'd
        # at build), so each (new slot, body) matches at most one old slot:
        # an index match and a gather, an exact select
        eq = (partner[:, None, :] == prev_id[None, :, :]) & pvalid[:, None, :]  # [Pq, Pp, NB]
        hit = torch.any(eq, dim=1)
        src = torch.argmax(eq.to(torch.uint8), dim=1)            # [Pq, NB]
        wlam = torch.gather(prev_lam, 2, src[None, None].expand(3, k, Pn, nb))
        keep = active & hit[None]
        ln, l1, l2 = (torch.where(keep, wlam[j], 0.0) for j in range(3))
        gn, g1, g2 = (torch.where(g_active, prev_glam[j], 0.0) for j in range(3))
        # apply carried impulses up front (accumulators stay incremental)
        imp = torch.where(active[None], normal * ln[None] + t1 * l1[None] + t2 * l2[None], 0.0)
        g_imp = torch.where(g_active[None], g_normal * gn[None] + g_t1 * g1[None]
                            + g_t2 * g2[None], 0.0)
        acc = body_impulse(imp, g_imp)
        v = vel + acc[0:3] * imn
        w = angvel + acc[3:6] * iiw
        for _ in range(iterations):
            pv, pw, _pd, _pk = partner_vw(v, w)
            vr = rel_vel(v, w, pv, pw)
            vn = torch.sum(vr * normal, dim=0)
            dln = (target - vn) / kn * relax
            new_n = torch.clamp_min(ln + dln, 0.0)
            dln = torch.where(active, new_n - ln, 0.0)
            vt1 = torch.sum(vr * t1, dim=0)
            vt2 = torch.sum(vr * t2, dim=0)
            lmax = fric_pair[None] * (ln + dln)
            n1 = torch.clamp(l1 + (-vt1 / kt1) * relax, -lmax, lmax)
            n2 = torch.clamp(l2 + (-vt2 / kt2) * relax, -lmax, lmax)
            d1 = torch.where(active, n1 - l1, 0.0)
            d2 = torch.where(active, n2 - l2, 0.0)
            # impulse convention: +imp acts on hi, −imp on lo (normal points
            # lo → hi)
            imp = torch.where(active[None], normal * dln[None] + t1 * d1[None] + t2 * d2[None],
                              0.0)
            # ground
            g_vr = -(v[:, None] + lm.cross(w[:, None].expand(g_r.shape), g_r, axis=0))
            g_vn = torch.sum(g_vr * g_normal, dim=0)
            g_dln = (g_target - g_vn) / g_kn * g_relax
            g_new = torch.clamp_min(gn + g_dln, 0.0)
            g_dln = torch.where(g_active, g_new - gn, 0.0)
            g_vt1 = torch.sum(g_vr * g_t1, dim=0)
            g_vt2 = torch.sum(g_vr * g_t2, dim=0)
            g_max = g_fric * (gn + g_dln)
            g_n1 = torch.clamp(g1 + (-g_vt1 / g_kt1) * g_relax, -g_max, g_max)
            g_n2 = torch.clamp(g2 + (-g_vt2 / g_kt2) * g_relax, -g_max, g_max)
            g_d1 = torch.where(g_active, g_n1 - g1, 0.0)
            g_d2 = torch.where(g_active, g_n2 - g2, 0.0)
            g_imp = torch.where(g_active[None], g_normal * g_dln[None] + g_t1 * g_d1[None]
                                + g_t2 * g_d2[None], 0.0)
            acc = body_impulse(imp, g_imp)
            v = v + acc[0:3] * imn
            w = w + acc[3:6] * iiw
            ln, l1, l2 = ln + dln, l1 + d1, l2 + d2
            gn, g1, g2 = gn + g_dln, g1 + g_d1, g2 + g_d2
        vel, angvel = v, w

        if settle_damping > 0.0:
            # near-sleep stabilization: a SUPPORTED body slower than
            # 4·sleep_speed bleeds energy; free flight is never damped
            sp2_post = torch.sum(vel * vel, 0) + torch.sum(angvel * angvel, 0)
            damp_m = (sp2_post < (4.0 * sleep_speed) ** 2) & (deg > 0.0) & dyn_j
            f = torch.where(damp_m, 1.0 - settle_damping, 1.0)[None]
            vel = vel * f
            angvel = angvel * f

        pos, rot = P.integrate_positions(pos, rot, vel, angvel, dt, dyn_j)

        # ---- split-impulse position projection -----------------------------
        if position_iterations > 0:
            # max_correction caps the per-frame positional push, so deep
            # impact frames depenetrate over several frames
            e0 = torch.where(active, torch.clamp(depth - slop, 0.0, max_correction), 0.0)
            g_e0 = torch.where(g_active, torch.clamp(g_depth - slop, 0.0, max_correction), 0.0)
            k_pos = torch.clamp_min(lo_im * s_lo[0] + hi_im * s_hi[0], 1e-9)[None]
            g_kp = torch.clamp_min(g_split * imn, 1e-9)
            dpos = torch.zeros_like(pos)
            pl, pgl = torch.zeros_like(e0), torch.zeros_like(g_e0)
            for _ in range(position_iterations):
                lo_dp, hi_dp = sel3(dpos, _gather_rows(dpos, pidx))
                sep = torch.sum((hi_dp[:, None] - lo_dp[:, None]) * normal, dim=0)
                dl = (e0 - sep) / k_pos
                new = torch.clamp_min(pl + dl, 0.0)
                dl = torch.where(active, new - pl, 0.0)
                step_v = torch.where(active[None], normal * dl[None], 0.0)
                d_acc = torch.sum(-sign[None, None] * step_v, dim=(1, 2))
                g_sep = torch.sum((-dpos[:, None, :]) * g_normal, dim=0)
                g_dl = (g_e0 - g_sep) / g_kp
                g_new = torch.clamp_min(pgl + g_dl, 0.0)
                g_dl = torch.where(g_active, g_new - pgl, 0.0)
                step_g = torch.where(g_active[None], g_normal * g_dl[None], 0.0)
                d_acc = d_acc - torch.sum(step_g, dim=1)
                dpos, pl, pgl = dpos + d_acc * imn, new, g_new
            pos = pos + dpos

        counters = {
            "active_contacts": (torch.sum(active) + torch.sum(g_active)).to(I32),
            "sap_window_miss": certs["slot_drop"] + certs["column_miss"],
            "slot_drop": certs["slot_drop"],
            "column_miss": certs["column_miss"],
            "max_candidates": certs["max_candidates"],
            "sleeping": torch.sum(asleep).to(I32),
        }
        carry_out = (torch.stack([ln, l1, l2]), partner, torch.stack([gn, g1, g2]),
                     sleep_ctr, wake_next, deep_next)
        return pos, rot, vel, angvel, counters, carry_out

    step.init_carry = init_carry
    step.init_consts = init_consts
    return step
