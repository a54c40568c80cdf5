"""Banded sweep-order pipeline (counterpart of
``lumixengine_tpu/ops/physics_banded.py``): the shift views, the banded
partner views, the leading-component-axis contact frame helpers, the
multi-offset column sweeps with their coverage certificates, and what the
PhysicsModule's banded branch runs on them: the banded narrowphase grids
(analytic, and the polytope SAT for pairs with a convex hull),
the multi-sweep Jacobi solve and position projection, the warm-start match
across frames and the cross-sweep dedup. The slot-compacted pipeline
(``physics_slots.py``) stands on the first four.

After a sweep's sort every candidate pair joins rank i to rank i+d, d <= K,
so a pair's data is a shifted view and an impulse's scatter a shifted sum:
the solve runs on [k, K, NB] slot grids with one rank gather and one
scatter per sweep and pass. The reference's single-sweep
``solve_contacts_banded`` / ``project_positions_banded``, its
``make_banded_world_step`` (the bench's stand-alone banded world step,
outside the PhysicsModule) and ``exact_window_miss`` are not ported.

Layout: body axis last; where a component axis exists it LEADS (``[3, ...,
NB]``), as in the reference's banded grids. Sweep orders, ranks and column
keys are int32 as in the reference; index arithmetic casts to int64 where a
tensor is used to index.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from lumixengine_tpu_torch.core import math as lm

_FAR = 1 << 24        # sort key offset that puts dead slots last


def _fwd(x, d: int):
    """Partner view: out[..., i] = x[..., i+d] (zero-padded tail)."""
    d = min(d, x.shape[-1])
    if d == 0:
        return x
    return F.pad(x[..., d:], (0, d))


def _back(y, d: int):
    """Scatter view: out[..., i+d] += y[..., i] → right shift by d."""
    d = min(d, y.shape[-1])
    if d == 0:
        return y
    return F.pad(y[..., :-d], (d, 0))


def back_sum(y, K: int):
    """Sum of the K scatter views: [.., K, NB] → [.., NB] with
    out[.., i] = Σ_d y[.., d-1, i-d] (the reference's loop of _back adds),
    as one flat-reshape skew and one sum."""
    nb = y.shape[-1]
    s = nb + K + 1
    yp = F.pad(y, (1, K))                                  # [.., K, S]: y at 1..NB
    flat = yp.reshape(y.shape[:-2] + (K * s,))[..., :K * (s - 1)]
    return flat.reshape(y.shape[:-2] + (K, s - 1)).sum(dim=-2)[..., :nb]


def banded_pair_data(x, K: int):
    """Stack the K partner views: [.., NB] → [.., K, NB] where
    out[.., d-1, i] = x[.., i+d] (zero-padded tail). A strided view of the
    padded input (window i of width K+1 starts at i)."""
    px = F.pad(x, (0, K))                                # [.., NB+K]
    return px.unfold(-1, K + 1, 1)[..., 1:].transpose(-1, -2)


def wrap_int32(x):
    """int64 → int32 with two's-complement wrap-around (as int32 arithmetic
    wraps in the reference)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _tangents0(n):
    """Orthonormal tangents for normals with the component axis leading."""
    nx = n[0]
    use_x = torch.abs(nx) < 0.9
    h = torch.stack([torch.where(use_x, 1.0, 0.0), torch.where(use_x, 0.0, 1.0),
                     torch.zeros_like(nx)], dim=0)
    t1 = lm.cross(n, h, axis=0)
    t1 = t1 * torch.rsqrt(torch.clamp_min(torch.sum(t1 * t1, dim=0, keepdim=True), 1e-12))
    t2 = lm.cross(n, t1, axis=0)
    return t1, t2


def _ang0(r, d, II):
    """d · ((I⁻¹ (r × d)) × r), leading component axis."""
    rxd = lm.cross(r, d, axis=0)
    return torch.sum(lm.cross(II * rxd, r, axis=0) * d, dim=0)


def _beyond(nb: int, K: int, device):
    beyond = torch.arange(nb, device=device) + K + 1
    return beyond < nb, torch.clamp_max(beyond, nb - 1)


def window_miss(s_mn, s_mx, K: int, occ=None):
    """Bodies whose x-extent overlaps past the K-th successor — candidates the
    bounded window may prune (0 ⇒ the window was wide enough this step)."""
    in_range, idx = _beyond(s_mn.shape[-1], K, s_mn.device)
    m = (s_mx[..., 0, :] >= s_mn[..., 0, :].index_select(-1, idx)) & in_range
    if occ is not None:
        m = m & occ
    return torch.sum(m).to(torch.int32)


def sweep_orders(mn, mx, occ, n_sweeps: int):
    """Sort orders for multi-axis banded sweeps (single world, [3, NB]).

    n_sweeps = 1: the classic min-x sweep; 2: column sweeps at offsets
    (0,0), (h,h); 4: all four (x, z) offset combos — the guaranteed-coverage
    mode (every overlapping pair shares a column in one of them); 5: classic
    + the four.  Column sweeps sort by the packed (qx, qz) cell id, then by
    min-y within a column (two stable sorts).

    Returns (orders [rank → body, int64 [NB] each: index tensors, the
    reference's int32 values], ranks [body → rank, int32 [NB] each],
    col_keys [int32 [NB] body-order packed column id per sweep, or None for
    the classic sweep])."""
    c = 0.5 * (mn + mx)
    ext = mx - mn
    max_ext = torch.max(torch.where(occ[..., None, :], ext, 0.0))
    cell = torch.clamp_min(2.02 * max_ext, 1e-3)
    half = 0.5 * cell
    far = torch.where(occ, 0, _FAR)                      # int64
    farf = torch.where(occ, 0.0, 1e18)

    def lex_order(minor_vals, key_packed):
        o = torch.argsort(minor_vals + farf, dim=-1, stable=True)
        kk = wrap_int32(key_packed.to(torch.int64) + far).index_select(-1, o)
        return o.index_select(-1, torch.argsort(kk, dim=-1, stable=True))

    def col_order(off_x, off_z):
        qx = torch.floor((c[..., 0, :] - off_x) / cell).to(torch.int32)
        qz = torch.floor((c[..., 2, :] - off_z) / cell).to(torch.int32)
        # packed column id (qx << 16) | (qz & 0xFFFF) on int32, wrapping:
        # collisions only ever declare two columns falsely EQUAL, which
        # inflates the miss certificate (conservative, never unsound)
        key = wrap_int32((qx.to(torch.int64) << 16) | (qz.to(torch.int64) & 0xFFFF))
        return lex_order(mn[..., 1, :], key), key

    if n_sweeps == 1:
        offs = []
    elif n_sweeps == 2:
        offs = [(0.0, 0.0), (half, half)]
    else:
        offs = [(0.0, 0.0), (half, 0.0), (0.0, half), (half, half)]
    orders, col_keys = [], []
    if n_sweeps == 1 or n_sweeps >= 5:
        orders.append(torch.argsort(mn[..., 0, :] + farf, dim=-1, stable=True))
        col_keys.append(None)
    for ox, oz in offs:
        o, key = col_order(ox, oz)
        orders.append(o)
        col_keys.append(key)
    iota = torch.arange(mn.shape[-1], dtype=torch.int32, device=mn.device)
    ranks = [torch.empty_like(iota).scatter_(0, o, iota) for o in orders]
    return orders, ranks, col_keys


def column_window_miss(s_mn, s_mx, s_col, K: int, occ=None):
    """Per-sweep exactness certificate for a column sweep: counts bodies
    whose y-extent reaches their SAME-COLUMN rank-(i+K+1) successor. All
    inputs rank-ordered."""
    in_range, idx = _beyond(s_mn.shape[-1], K, s_mn.device)
    m = ((s_mx[..., 1, :] >= s_mn[..., 1, :].index_select(-1, idx))
         & (s_col == s_col.index_select(-1, idx)) & in_range)
    if occ is not None:
        m = m & occ
    return torch.sum(m).to(torch.int32)


def banded_pair_grids(sp, sr, s_rad, s_he, s_shape, s_mn, s_mx, K: int, k: int,
                      any_caps: bool):
    """Banded narrowphase on rank-ordered body data (single world): the
    partner views through pair_contacts_from_data → ([.., k, K, NB]
    point/normal/depth/raw-active grids, ok = rank validity & AABB overlap
    [K, NB]). Callers AND their own masks (layers, occupancy, dynamics) into
    the active grid."""
    from lumixengine_tpu_torch.ops import physics_ops as P

    nb = sp.shape[-1]
    valid_rank = (torch.arange(1, K + 1, device=sp.device)[:, None]
                  + torch.arange(nb, device=sp.device)[None, :]) < nb
    bmn, bmx = banded_pair_data(s_mn, K), banded_pair_data(s_mx, K)
    overlap = torch.all((s_mn[:, None, :] <= bmx) & (bmn <= s_mx[:, None, :]), dim=-3)
    ok = overlap & valid_rank

    def bcast(x):
        return x.unsqueeze(-2).expand(x.shape[:-1] + (K, nb)).reshape(x.shape[:-1] + (K * nb,))

    def partner(x):
        return banded_pair_data(x, K).reshape(x.shape[:-1] + (K * nb,))

    point, normal, depth, active = P.pair_contacts_from_data(
        bcast(sp), bcast(sr), bcast(s_rad), bcast(s_he), bcast(s_shape),
        partner(sp), partner(sr), partner(s_rad), partner(s_he), partner(s_shape),
        points_per_pair=k, any_caps=any_caps)

    def grid(x):
        return x.reshape(x.shape[:-1] + (k, K, nb))

    return grid(point), grid(normal), grid(depth), grid(active), ok


def banded_polytope_grids(sp, sr, s_pv, s_pax, s_prad, K: int, k: int):
    """The padded-polytope SAT (convex_ops.polytope_pair_contacts_from_data,
    the narrowphase of the all-pairs branch's convex pairs) over the banded
    partner views. Inputs rank-ordered: s_pv [3, V, NB] local vertices,
    s_pax [3, F, NB] local unit face axes, s_prad [NB] support radii.
    Returns [(3,) k, K, NB] grids (point, normal, depth, active), the
    contract of banded_pair_grids without its ok mask."""
    from lumixengine_tpu_torch.ops import convex_ops as CV

    nb = sp.shape[-1]

    def bcast(x):
        return x.unsqueeze(-2).expand(x.shape[:-1] + (K, nb)).reshape(x.shape[:-1] + (K * nb,))

    def partner(x):
        return banded_pair_data(x, K).reshape(x.shape[:-1] + (K * nb,))

    point, normal, depth, active = CV.polytope_pair_contacts_from_data(
        bcast(sp), bcast(sr), bcast(s_pv), bcast(s_pax), bcast(s_prad),
        partner(sp), partner(sr), partner(s_pv), partner(s_pax), partner(s_prad),
        points_per_pair=k)

    def grid(x):
        return x.reshape(x.shape[:-1] + (k, K, nb))

    return grid(point), grid(normal), grid(depth), grid(active)


def _degree(sw, K: int):
    """Active contacts per body of one sweep, in its rank space [NB]."""
    pa = sw["p_active"].to(torch.float32)
    deg = torch.sum(pa, dim=(-3, -2)) + back_sum(torch.sum(pa, dim=-3), K)
    if "g_active" in sw:
        deg = deg + torch.sum(sw["g_active"].to(torch.float32), dim=-2)
    return deg


def _body_degree(sweeps, nb: int, device):
    """Active contacts per body over every sweep, in body order [NB]."""
    deg = torch.zeros(nb, device=device)
    for sw in sweeps:
        deg = deg + torch.zeros_like(deg).index_copy(
            -1, sw["order"], _degree(sw, sw["p_normal"].shape[-2]))
    return deg


def _unrank(x_r, order):
    """Rank-ordered [.., NB] back to body order."""
    return torch.zeros_like(x_r).index_copy(-1, order, x_r)


def _six(imp, r):
    return torch.cat([imp, lm.cross(r, imp, axis=0)], dim=0)


def solve_contacts_banded_multi(vel, angvel, inv_mass_body, iiw_body, pos_body, sweeps, dt,
                                iterations: int = 8, baumgarte: float = 0.0,
                                slop: float = 0.005, relaxation: float = 0.75, warm=None):
    """Multi-sweep projected-Jacobi PGS (single world, body-order vel/angvel
    [3, NB]): each pass applies every sweep's banded contact block in its
    own rank space. `sweeps` are dicts with `order` (int64 [NB]) and the
    banded grids p_point/p_normal ([3, k, K, NB]), p_depth/p_active/p_fric/
    p_rest ([k, K, NB]); the first may also carry ground grids g_* ([3, G,
    NB] / [G, NB]). `warm`: per-sweep dicts {"p": (λn, λt1, λt2) [k, K, NB]
    in this frame's rank space, "g": the ground lambdas [G, NB]}, applied
    up front and seeding the accumulators. Returns (vel, angvel, the
    per-sweep final lambdas (gl, gl1, gl2, pl, pl1, pl2))."""
    nb = vel.shape[-1]
    deg_body = _body_degree(sweeps, nb, vel.device)

    consts = []
    for sw in sweeps:
        order = sw["order"]
        K = sw["p_normal"].shape[-2]
        s_im = inv_mass_body.index_select(-1, order)
        s_iiw = iiw_body.index_select(-1, order)
        s_pos = pos_body.index_select(-1, order)
        s_deg = deg_body.index_select(-1, order)
        c = {"order": order, "K": K, "im": s_im, "iiw": s_iiw}
        pos_b = banded_pair_data(s_pos, K)
        iiw_b = banded_pair_data(s_iiw, K)
        im_b = banded_pair_data(s_im, K)
        c["p_ra"] = sw["p_point"] - s_pos[:, None, None, :]
        c["p_rb"] = sw["p_point"] - pos_b[:, None, :, :]
        c["p_t1"], c["p_t2"] = _tangents0(sw["p_normal"])
        imab = s_im[None, None, :] + im_b[None, :, :]
        II_a4, II_b4 = s_iiw[:, None, None, :], iiw_b[:, None, :, :]
        for key, dvec in (("p_kn", sw["p_normal"]), ("p_kt1", c["p_t1"]), ("p_kt2", c["p_t2"])):
            c[key] = torch.clamp_min(imab + _ang0(c["p_ra"], dvec, II_a4)
                                     + _ang0(c["p_rb"], dvec, II_b4), 1e-9)
        deg_b = banded_pair_data(s_deg, K)
        c["p_relax"] = torch.clamp_max(1.6 / torch.clamp_min(
            torch.maximum(s_deg[None, None, :], deg_b[None, :, :]), 1.0), relaxation)
        c["p_bias"] = (baumgarte / dt) * torch.clamp_min(sw["p_depth"] - slop, 0.0)
        if "g_active" in sw:
            c["g_r"] = sw["g_point"] - s_pos[:, None, :]
            c["g_t1"], c["g_t2"] = _tangents0(sw["g_normal"])
            imn = s_im[None, :]
            for key, dvec in (("g_kn", sw["g_normal"]), ("g_kt1", c["g_t1"]),
                              ("g_kt2", c["g_t2"])):
                c[key] = torch.clamp_min(imn + _ang0(c["g_r"], dvec, s_iiw[:, None, :]), 1e-9)
            c["g_relax"] = torch.clamp_max(1.6 / torch.clamp_min(s_deg[None, :], 1.0),
                                           relaxation)
            c["g_bias"] = (baumgarte / dt) * torch.clamp_min(sw["g_depth"] - slop, 0.0)
        consts.append(c)

    def rel_vels(c, v_r, w_r):
        K = c["K"]
        vw = torch.cat([v_r, w_r], dim=0)
        va_p = vw[0:3][:, None, None, :] + lm.cross(
            vw[3:6][:, None, None, :].expand(c["p_ra"].shape), c["p_ra"], axis=0)
        vw_b = banded_pair_data(vw, K)
        vb_p = vw_b[0:3][:, None, :, :] + lm.cross(
            vw_b[3:6][:, None, :, :].expand(c["p_rb"].shape), c["p_rb"], axis=0)
        g_vr = None
        if "g_r" in c:
            g_vr = -(vw[0:3][:, None, :] + lm.cross(vw[3:6][:, None, :].expand(c["g_r"].shape),
                                                     c["g_r"], axis=0))
        return g_vr, vb_p - va_p

    for c, sw in zip(consts, sweeps):
        g_vr0, p_vr0 = rel_vels(c, vel.index_select(-1, c["order"]),
                                angvel.index_select(-1, c["order"]))
        p_vn0 = torch.sum(p_vr0 * sw["p_normal"], dim=0)
        c["p_target"] = torch.maximum(c["p_bias"], torch.where(
            p_vn0 < -0.5, -sw["p_rest"] * p_vn0, 0.0))
        if g_vr0 is not None:
            g_vn0 = torch.sum(g_vr0 * sw["g_normal"], dim=0)
            c["g_target"] = torch.maximum(c["g_bias"], torch.where(
                g_vn0 < -0.5, -sw["g_rest"] * g_vn0, 0.0))

    def pgs(vr, nrm, t1, t2, target, kn, kt1, kt2, relax, fric, active, l0, l1, l2):
        """One projected-Jacobi update of a slot grid → (impulse, dλn, dλt1, dλt2)."""
        vn = torch.sum(vr * nrm, dim=0)
        dln = (target - vn) / kn * relax
        dln = torch.where(active, torch.clamp_min(l0 + dln, 0.0) - l0, 0.0)
        max_f = fric * (l0 + dln)
        n1 = torch.clamp(l1 + (-torch.sum(vr * t1, dim=0) / kt1) * relax, -max_f, max_f)
        n2 = torch.clamp(l2 + (-torch.sum(vr * t2, dim=0) / kt2) * relax, -max_f, max_f)
        d1 = torch.where(active, n1 - l1, 0.0)
        d2 = torch.where(active, n2 - l2, 0.0)
        imp = torch.where(active[None], nrm * dln[None] + t1 * d1[None] + t2 * d2[None], 0.0)
        return imp, dln, d1, d2

    def apply(c, v_r, w_r, g_imp, p_imp):
        acc = 0.0
        if g_imp is not None:
            acc = -torch.sum(_six(g_imp, c["g_r"]), dim=-2)
        acc = acc - torch.sum(_six(p_imp, c["p_ra"]), dim=(-3, -2))
        acc = acc + back_sum(torch.sum(_six(p_imp, c["p_rb"]), dim=-3), c["K"])
        return v_r + acc[0:3] * c["im"][None, :], w_r + acc[3:6] * c["iiw"]

    def sweep_iter(c, sw, v, w, lams):
        order = c["order"]
        v_r, w_r = v.index_select(-1, order), w.index_select(-1, order)
        g_vr, p_vr = rel_vels(c, v_r, w_r)
        gl, gl1, gl2, pl, pl1, pl2 = lams
        g_imp = None
        if g_vr is not None:
            g_imp, g_dln, g_d1, g_d2 = pgs(g_vr, sw["g_normal"], c["g_t1"], c["g_t2"],
                                          c["g_target"], c["g_kn"], c["g_kt1"], c["g_kt2"],
                                          c["g_relax"], sw["g_fric"], sw["g_active"],
                                          gl, gl1, gl2)
            gl, gl1, gl2 = gl + g_dln, gl1 + g_d1, gl2 + g_d2
        p_imp, p_dln, p_d1, p_d2 = pgs(p_vr, sw["p_normal"], c["p_t1"], c["p_t2"],
                                      c["p_target"], c["p_kn"], c["p_kt1"], c["p_kt2"],
                                      c["p_relax"], sw["p_fric"], sw["p_active"], pl, pl1, pl2)
        v_r, w_r = apply(c, v_r, w_r, g_imp, p_imp)
        return (_unrank(v_r, order), _unrank(w_r, order),
                (gl, gl1, gl2, pl + p_dln, pl1 + p_d1, pl2 + p_d2))

    lams = []
    for i, sw in enumerate(sweeps):
        zp = torch.zeros_like(sw["p_depth"])
        zg = torch.zeros_like(sw["g_depth"]) if "g_depth" in sw else torch.zeros((), device=zp.device)
        lam = [zg, zg, zg, zp, zp, zp]
        w_s = warm[i] if warm is not None else None
        if w_s:
            if w_s.get("p") is not None:
                lam[3:] = [torch.where(sw["p_active"], x, 0.0) for x in w_s["p"]]
            if w_s.get("g") is not None and "g_depth" in sw:
                lam[:3] = [torch.where(sw["g_active"], x, 0.0) for x in w_s["g"]]
        lams.append(tuple(lam))

    if warm is not None:   # apply the carried impulses up front
        for c, sw, lam in zip(consts, sweeps, lams):
            gl, gl1, gl2, pl, pl1, pl2 = lam
            order = c["order"]
            g_imp = None
            if "g_r" in c and gl.dim():
                g_imp = torch.where(sw["g_active"][None], sw["g_normal"] * gl[None]
                                    + c["g_t1"] * gl1[None] + c["g_t2"] * gl2[None], 0.0)
            p_imp = torch.where(sw["p_active"][None], sw["p_normal"] * pl[None]
                                + c["p_t1"] * pl1[None] + c["p_t2"] * pl2[None], 0.0)
            v_r, w_r = apply(c, vel.index_select(-1, order), angvel.index_select(-1, order),
                             g_imp, p_imp)
            vel, angvel = _unrank(v_r, order), _unrank(w_r, order)

    for _ in range(iterations):
        for i, (c, sw) in enumerate(zip(consts, sweeps)):
            vel, angvel, lams[i] = sweep_iter(c, sw, vel, angvel, lams[i])
    return vel, angvel, tuple(lams)


def match_warm_lams(prev_lams, prev_rank, order, K: int):
    """Carry accumulated pair impulses across frames in rank space.

    prev_lams [L, k, K, NB] in the previous frame's rank space (λn, λt1,
    λt2), prev_rank int32 [NB] the previous body → rank map (-1: cold),
    order int64 [NB] this frame's rank → body map. Returns [L, k, K, NB] in
    this frame's rank space: slot (d-1, i) holds the previous lambdas of the
    pair (order[i], order[i+d]) if it sat in the previous window in either
    orientation, else 0. A pair whose ranks crossed keeps λn and λt1 and
    flips λt2 (n' = -n gives t1' = -t1, t2' = t2)."""
    nb = order.shape[-1]
    r2p = prev_rank.index_select(-1, order).to(torch.int64)
    r2p_safe = torch.where(r2p < 0, -(1 << 20), r2p)
    partner = banded_pair_data(r2p_safe, K)              # [K, NB]
    delta = partner - r2p_safe[None, :]
    fwd = (delta >= 1) & (delta <= K)
    bwd = (delta <= -1) & (delta >= -K)
    valid = (fwd | bwd) & (r2p[None, :] >= 0) & (partner >= 0)
    didx = torch.where(fwd, delta, -delta) - 1
    base = torch.where(fwd, r2p_safe[None, :], partner)
    flat = torch.clamp(didx * nb + base, 0, K * nb - 1)
    src = prev_lams.reshape(prev_lams.shape[:-2] + (K * nb,))
    out = src.index_select(-1, flat.reshape(-1)).reshape(prev_lams.shape)
    out = torch.where(valid, out, 0.0)
    sign = torch.where(bwd, -1.0, 1.0)
    return torch.cat([out[:2], out[2:3] * sign, out[3:]], dim=0)


def project_positions_banded_multi(pos_body, sweeps, inv_mass_body, iterations: int = 3,
                                   slop: float = 0.005, relaxation: float = 0.8,
                                   max_correction: float = 0.05):
    """Multi-sweep split-impulse position projection (single world,
    body-order positions [3, NB]); the per-frame push is capped at
    max_correction, as in the reference."""
    if iterations <= 0:
        return pos_body
    deg_body = _body_degree(sweeps, pos_body.shape[-1], pos_body.device)
    consts = []
    for sw in sweeps:
        order = sw["order"]
        K = sw["p_normal"].shape[-2]
        s_im = inv_mass_body.index_select(-1, order)
        s_deg = deg_body.index_select(-1, order)
        c = {"order": order, "K": K, "im": s_im,
             "p_k": torch.clamp_min(s_im[None, None, :] + banded_pair_data(s_im, K)[None], 1e-9),
             "p_e0": torch.where(sw["p_active"],
                                 torch.clamp(sw["p_depth"] - slop, 0.0, max_correction), 0.0),
             "p_rx": torch.clamp_max(1.6 / torch.clamp_min(torch.maximum(
                 s_deg[None, None, :], banded_pair_data(s_deg, K)[None]), 1.0), relaxation)}
        if "g_active" in sw:
            c["g_k"] = torch.clamp_min(s_im[None, :], 1e-9)
            c["g_e0"] = torch.where(sw["g_active"],
                                    torch.clamp(sw["g_depth"] - slop, 0.0, max_correction), 0.0)
            c["g_rx"] = torch.clamp_max(1.6 / torch.clamp_min(s_deg[None, :], 1.0), relaxation)
        consts.append(c)

    dpos = torch.zeros_like(pos_body)
    lams = [(torch.zeros_like(sw["g_depth"]) if "g_depth" in sw else None,
             torch.zeros_like(sw["p_depth"])) for sw in sweeps]
    for _ in range(iterations):
        for i, (c, sw) in enumerate(zip(consts, sweeps)):
            order = c["order"]
            dp_r = dpos.index_select(-1, order)
            gl, pl = lams[i]
            d_acc = 0.0
            if "g_k" in c:
                g_sep = torch.sum((-dp_r[:, None, :]) * sw["g_normal"], dim=0)
                g_dl = (c["g_e0"] - g_sep) / c["g_k"] * c["g_rx"]
                g_dl = torch.where(sw["g_active"], torch.clamp_min(gl + g_dl, 0.0) - gl, 0.0)
                d_acc = -torch.sum(torch.where(sw["g_active"][None],
                                               sw["g_normal"] * g_dl[None], 0.0), dim=-2)
                gl = gl + g_dl
            dp_b = banded_pair_data(dp_r, c["K"])
            p_sep = torch.sum((dp_b[:, None, :, :] - dp_r[:, None, None, :]) * sw["p_normal"],
                              dim=0)
            p_dl = (c["p_e0"] - p_sep) / c["p_k"] * c["p_rx"]
            p_new = torch.clamp_min(pl + p_dl, 0.0)
            p_dl = torch.where(sw["p_active"], p_new - pl, 0.0)
            step_p = torch.where(sw["p_active"][None], sw["p_normal"] * p_dl[None], 0.0)
            d_acc = (d_acc - torch.sum(step_p, dim=(-3, -2))
                     + back_sum(torch.sum(step_p, dim=-3), c["K"]))
            dpos = _unrank(dp_r + d_acc * c["im"][None, :], order)
            lams[i] = (gl, pl + p_dl)
    return pos_body + dpos


def cross_sweep_coverage(order_s, ranks_earlier, K: int):
    """[K, NB] mask: banded slot (d-1, i) of this sweep already inside an
    earlier sweep's window (rank distance <= K there); None for the first
    sweep."""
    covered = None
    for rk in ranks_earlier:
        rr = rk.index_select(-1, order_s)
        c = torch.abs(banded_pair_data(rr, K) - rr[None, :]) <= K
        covered = c if covered is None else (covered | c)
    return covered
