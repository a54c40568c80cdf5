"""Banded sweep-order pipeline (counterpart of
``lumixengine_tpu/ops/physics_banded.py``): the shift views, the banded
partner views, the leading-component-axis contact frame helpers, the
multi-offset column sweeps with their coverage certificates, the banded
narrowphase grids (analytic, and the polytope SAT for pairs with a convex
hull), the single-sweep and multi-sweep Jacobi solves and position
projections, the warm-start match across frames, the cross-sweep dedup, the
exact all-pairs coverage count ``exact_window_miss``, the banded contact
stage ``banded_sweeps`` / ``banded_carry`` and the stand-alone world step
``make_banded_world_step``. The PhysicsModule's banded branch and the
stand-alone step build their sweeps through that one stage; the
slot-compacted pipeline (``physics_slots.py``) stands on the sweeps and
views. On the card the multi-sweep Jacobi solve is one hand-written
kernel, ``csrc/banded_jacobi.cu`` (``solve_contacts_banded_cuda``), and the
contact stage another, ``csrc/banded_grids.cu`` (``banded_sweeps_cuda``);
CPU tensors take their plain versions.

After a sweep's sort every candidate pair joins rank i to rank i+d, d <= K,
so a pair's data is a shifted view and an impulse's scatter a shifted sum:
the solve runs on [k, K, NB] slot grids with one rank gather and one
scatter per sweep and pass.

Layout: body axis last. Every function takes leading world axes, as the
reference's take them under ``vmap``: per-body rows ``[..., NB]``, vectors
``[..., 3, NB]``, and the banded grids ``[..., 3, k, K, NB]`` /
``[..., 3, G, NB]`` with their component axis right after the world axes
(axis -4 of a pair grid, -3 of a ground grid). Sweep orders are int64
index tensors ``[..., NB]`` (each world sorts its own bodies: a gather
along the last axis), ranks and column keys int32 as in the reference.
Every argsort is stable, as ``jnp.argsort`` is: ties decide ranks.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from lumixengine_tpu_torch.core import math as lm
from lumixengine_tpu_torch.core import profiler
from lumixengine_tpu_torch.ops import native
from lumixengine_tpu_torch.ops import physics_ops as P

AX = -2              # component axis of body arrays [..., 3, NB]
_FAR = 1 << 24        # sort key offset that puts dead slots last

# a sweep dict's banded grids: pair grids [..., (3,) k, K, NB] and, on a sweep
# that holds the ground stream, ground grids [..., (3,) G, NB]; beside them
# "order", the sweep's rank -> body map
PAIR_KEYS = ("p_point", "p_normal", "p_depth", "p_active", "p_fric", "p_rest")
GROUND_KEYS = ("g_point", "g_normal", "g_depth", "g_active", "g_fric", "g_rest")


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


def take_ranked(x, order):
    """x [..., *inner, NB] at per-world indices order [..., M] along the
    last axis (x carries order's world axes) → [..., *inner, M]."""
    if order.dim() == 1:
        return x.index_select(-1, order)
    b = order.dim() - 1
    idx = order.reshape(order.shape[:-1] + (1,) * (x.dim() - b - 1) + order.shape[-1:])
    return torch.gather(x, -1, idx.expand(x.shape[:-1] + order.shape[-1:]))


def unrank(x_r, order):
    """Rank-ordered [..., *inner, NB] back to body order (order: rank →
    body, [..., NB])."""
    if order.dim() == 1:
        return torch.zeros_like(x_r).index_copy(-1, order, x_r)
    b = order.dim() - 1
    idx = order.reshape(order.shape[:-1] + (1,) * (x_r.dim() - b - 1) + order.shape[-1:])
    return torch.zeros_like(x_r).scatter_(-1, idx.expand(x_r.shape), x_r)


def _tangents0(n, axis: int = 0):
    """Orthonormal tangents for normals whose component axis is `axis`
    (the banded grids' leading one)."""
    nx = n.select(axis, 0)
    use_x = torch.abs(nx) < 0.9
    h = torch.stack([torch.where(use_x, 1.0, 0.0), torch.where(use_x, 0.0, 1.0),
                     torch.zeros_like(nx)], dim=axis)
    t1 = lm.cross(n, h, axis=axis)
    t1 = t1 * torch.rsqrt(torch.clamp_min(torch.sum(t1 * t1, dim=axis, keepdim=True), 1e-12))
    t2 = lm.cross(n, t1, axis=axis)
    return t1, t2


def _ang0(r, d, II, axis: int = 0):
    """d · ((I⁻¹ (r × d)) × r) over the component axis `axis`."""
    rxd = lm.cross(r, d, axis=axis)
    return torch.sum(lm.cross(II * rxd, r, axis=axis) * d, dim=axis)


def _beyond(nb: int, K: int, device):
    beyond = torch.arange(nb, device=device) + K + 1
    return beyond < nb, torch.clamp_max(beyond, nb - 1)


def window_miss(s_mn, s_mx, K: int, occ=None):
    """Bodies whose x-extent overlaps past the K-th successor — candidates the
    bounded window may prune (0 ⇒ the window was wide enough this step).
    Rank-ordered inputs; one count per world."""
    in_range, idx = _beyond(s_mn.shape[-1], K, s_mn.device)
    m = (s_mx[..., 0, :] >= s_mn[..., 0, :].index_select(-1, idx)) & in_range
    if occ is not None:
        m = m & occ
    return torch.sum(m, dim=-1).to(torch.int32)


def sweep_orders(mn, mx, occ, n_sweeps: int):
    """Sort orders for multi-axis banded sweeps, per world ([..., 3, NB]).

    n_sweeps = 1: the classic min-x sweep; 2: column sweeps at offsets
    (0,0), (h,h); 4: all four (x, z) offset combos — the guaranteed-coverage
    mode (every overlapping pair shares a column in one of them); 5: classic
    + the four.  Column sweeps sort by the packed (qx, qz) cell id, then by
    min-y within a column (two stable sorts); the cell is sized by each
    world's largest extent.

    Returns (orders [rank → body, int64 [..., NB] each], ranks [body → rank,
    int32 [..., NB] each], col_keys [int32 [..., NB] body-order packed column
    id per sweep, or None for the classic sweep])."""
    c = 0.5 * (mn + mx)
    ext = mx - mn
    max_ext = torch.amax(torch.where(occ[..., None, :], ext, 0.0), dim=(-2, -1))
    cell = torch.clamp_min(2.02 * max_ext, 1e-3).unsqueeze(-1)
    half = 0.5 * cell
    far = torch.where(occ, 0, _FAR)                      # int64
    farf = torch.where(occ, 0.0, 1e18)

    def lex_order(minor_vals, key_packed):
        o = torch.argsort(minor_vals + farf, dim=-1, stable=True)
        kk = take_ranked(wrap_int32(key_packed.to(torch.int64) + far), o)
        return take_ranked(o, torch.argsort(kk, dim=-1, stable=True))

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
    ranks = [unrank(iota.expand(o.shape), o) for o in orders]
    return orders, ranks, col_keys


def column_window_miss(s_mn, s_mx, s_col, K: int, occ=None):
    """Per-sweep exactness certificate for a column sweep: counts bodies
    whose y-extent reaches their SAME-COLUMN rank-(i+K+1) successor. All
    inputs rank-ordered; one count per world."""
    in_range, idx = _beyond(s_mn.shape[-1], K, s_mn.device)
    m = ((s_mx[..., 1, :] >= s_mn[..., 1, :].index_select(-1, idx))
         & (s_col == s_col.index_select(-1, idx)) & in_range)
    if occ is not None:
        m = m & occ
    return torch.sum(m, dim=-1).to(torch.int32)


def banded_pair_grids(sp, sr, s_rad, s_he, s_shape, s_mn, s_mx, K: int, k: int,
                      any_caps: bool):
    """Banded narrowphase on rank-ordered body data: the partner views
    through pair_contacts_from_data → ([.., (3,) k, K, NB]
    point/normal/depth/raw-active grids, ok = rank validity & AABB overlap
    [.., K, NB]). Callers AND their own masks (layers, occupancy, dynamics)
    into the active grid."""
    nb = sp.shape[-1]
    valid_rank = (torch.arange(1, K + 1, device=sp.device)[:, None]
                  + torch.arange(nb, device=sp.device)[None, :]) < nb
    bmn, bmx = banded_pair_data(s_mn, K), banded_pair_data(s_mx, K)
    overlap = torch.all((s_mn[..., :, None, :] <= bmx) & (bmn <= s_mx[..., :, None, :]), dim=-3)
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


# bytes the polytope SAT's vertex-by-axis products may hold at once: the
# window's partner ranks are taken in chunks that keep them under it
HULL_SAT_BYTES = 1 << 30


def hull_sat_chunk(batch: int, v: int, f: int, nb: int, K: int) -> int:
    """Partner ranks a chunk of banded_polytope_grids takes: the most whose
    two [batch, V, 2F + 1, chunk * NB] float32 vertex-by-axis products fit
    in HULL_SAT_BYTES together, at least 1 and at most K."""
    per_rank = 2 * 4 * batch * v * (2 * f + 1) * nb
    return max(1, min(K, HULL_SAT_BYTES // max(per_rank, 1)))


def banded_polytope_grids(sp, sr, s_pv, s_pax, s_prad, K: int, k: int):
    """The padded-polytope SAT (convex_ops.polytope_pair_contacts_from_data,
    the narrowphase of the all-pairs branch's convex pairs) over the banded
    partner views. Inputs rank-ordered: s_pv [.., 3, V, NB] local vertices,
    s_pax [.., 3, F, NB] local unit face axes, s_prad [.., NB] support radii.
    Returns [.., (3,) k, K, NB] grids (point, normal, depth, active), the
    contract of banded_pair_grids without its ok mask.

    The window's partner ranks d = 1..K are taken hull_sat_chunk's number
    at a time, each chunk's slots through the SAT at once: every slot's
    numbers are computed by the same operations whatever the chunk, so the
    chunks only bound the intermediates' bytes."""
    from lumixengine_tpu_torch.ops import convex_ops as CV

    nb = sp.shape[-1]
    chunk = hull_sat_chunk(math.prod(sp.shape[:-2]), s_pv.shape[-2], s_pax.shape[-2], nb, K)
    parts = []
    for d0 in range(0, K, chunk):
        c = min(chunk, K - d0)

        def bcast(x, c=c):
            return x.unsqueeze(-2).expand(x.shape[:-1] + (c, nb)).reshape(x.shape[:-1] + (c * nb,))

        def partner(x, d0=d0, c=c):
            return banded_pair_data(x, K)[..., d0:d0 + c, :].reshape(x.shape[:-1] + (c * nb,))

        out = CV.polytope_pair_contacts_from_data(
            bcast(sp), bcast(sr), bcast(s_pv), bcast(s_pax), bcast(s_prad),
            partner(sp), partner(sr), partner(s_pv), partner(s_pax), partner(s_prad),
            points_per_pair=k)
        parts.append([x.reshape(x.shape[:-1] + (k, c, nb)) for x in out])
    if len(parts) == 1:
        return tuple(parts[0])
    return tuple(torch.cat(xs, dim=-2) for xs in zip(*parts))


def hull_pair_active(sweeps, is_convex, K: int):
    """The active pair slots that hold a hull, over every sweep of the
    banded contact stage (its sweep dicts), int32 [...]: is_convex [NB] in
    body order."""
    n = None
    for sw in sweeps:
        order = sw["order"]
        cvx = take_ranked(is_convex.expand(order.shape), order)
        pair = cvx.unsqueeze(-2) | banded_pair_data(cvx, K)                 # [.., K, NB]
        c = torch.sum(sw["p_active"] & pair.unsqueeze(-3), dim=(-3, -2, -1))
        n = c if n is None else n + c
    return n.to(torch.int32)


def _degree(sw, K: int):
    """Active contacts per body of one sweep, in its rank space [.., NB]."""
    pa = sw["p_active"].to(torch.float32)
    deg = torch.sum(pa, dim=(-3, -2)) + back_sum(torch.sum(pa, dim=-3), K)
    if "g_active" in sw:
        deg = deg + torch.sum(sw["g_active"].to(torch.float32), dim=-2)
    return deg


def _body_degree(sweeps, shape, device):
    """Active contacts per body over every sweep, in body order [.., NB]."""
    deg = torch.zeros(shape, device=device)
    for sw in sweeps:
        deg = deg + unrank(_degree(sw, sw["p_normal"].shape[-2]), sw["order"])
    return deg


def _six(imp, r, axis: int):
    return torch.cat([imp, lm.cross(r, imp, axis=axis)], dim=axis)


def solve_contacts_banded_multi_plain(vel, angvel, inv_mass_body, iiw_body, pos_body, sweeps, dt,
                                      iterations: int = 8, baumgarte: float = 0.0,
                                      slop: float = 0.005, relaxation: float = 0.75, warm=None):
    """The plain version of solve_contacts_banded_multi, same contract:
    eager torch over the whole slot grids, each pass's intermediates as
    full grids."""
    nb = vel.shape[-1]
    body = vel.shape[:-2] + (nb,)
    deg_body = _body_degree(sweeps, body, vel.device)
    im_body = inv_mass_body.expand(body)

    consts = []
    for sw in sweeps:
        order = sw["order"]
        K = sw["p_normal"].shape[-2]
        s_im = take_ranked(im_body, order)
        s_iiw = take_ranked(iiw_body, order)
        s_pos = take_ranked(pos_body, order)
        s_deg = take_ranked(deg_body, order)
        c = {"order": order, "K": K, "im": s_im, "iiw": s_iiw}
        pos_b = banded_pair_data(s_pos, K)
        iiw_b = banded_pair_data(s_iiw, K)
        im_b = banded_pair_data(s_im, K)
        c["p_ra"] = sw["p_point"] - s_pos[..., :, None, None, :]
        c["p_rb"] = sw["p_point"] - pos_b[..., :, None, :, :]
        c["p_t1"], c["p_t2"] = _tangents0(sw["p_normal"], -4)
        imab = s_im[..., None, None, :] + im_b[..., None, :, :]
        II_a4, II_b4 = s_iiw[..., :, None, None, :], iiw_b[..., :, None, :, :]
        for key, dvec in (("p_kn", sw["p_normal"]), ("p_kt1", c["p_t1"]), ("p_kt2", c["p_t2"])):
            c[key] = torch.clamp_min(imab + _ang0(c["p_ra"], dvec, II_a4, -4)
                                     + _ang0(c["p_rb"], dvec, II_b4, -4), 1e-9)
        deg_b = banded_pair_data(s_deg, K)
        c["p_relax"] = torch.clamp_max(1.6 / torch.clamp_min(
            torch.maximum(s_deg[..., None, None, :], deg_b[..., None, :, :]), 1.0), relaxation)
        c["p_bias"] = P.baumgarte_bias(baumgarte, dt, sw["p_depth"], slop)
        if "g_active" in sw:
            c["g_r"] = sw["g_point"] - s_pos[..., :, None, :]
            c["g_t1"], c["g_t2"] = _tangents0(sw["g_normal"], -3)
            imn = s_im[..., None, :]
            for key, dvec in (("g_kn", sw["g_normal"]), ("g_kt1", c["g_t1"]),
                              ("g_kt2", c["g_t2"])):
                c[key] = torch.clamp_min(imn + _ang0(c["g_r"], dvec, s_iiw[..., :, None, :], -3),
                                         1e-9)
            c["g_relax"] = torch.clamp_max(1.6 / torch.clamp_min(s_deg[..., None, :], 1.0),
                                           relaxation)
            c["g_bias"] = P.baumgarte_bias(baumgarte, dt, sw["g_depth"], slop)
        consts.append(c)

    def rel_vels(c, v_r, w_r):
        K = c["K"]
        vw = torch.cat([v_r, w_r], dim=-2)
        va_p = vw[..., 0:3, None, None, :] + lm.cross(
            vw[..., 3:6, None, None, :].expand(c["p_ra"].shape), c["p_ra"], axis=-4)
        vw_b = banded_pair_data(vw, K)
        vb_p = vw_b[..., 0:3, None, :, :] + lm.cross(
            vw_b[..., 3:6, None, :, :].expand(c["p_rb"].shape), c["p_rb"], axis=-4)
        g_vr = None
        if "g_r" in c:
            g_vr = -(vw[..., 0:3, None, :] + lm.cross(
                vw[..., 3:6, None, :].expand(c["g_r"].shape), c["g_r"], axis=-3))
        return g_vr, vb_p - va_p

    for c, sw in zip(consts, sweeps):
        g_vr0, p_vr0 = rel_vels(c, take_ranked(vel, c["order"]), take_ranked(angvel, c["order"]))
        p_vn0 = torch.sum(p_vr0 * sw["p_normal"], dim=-4)
        c["p_target"] = torch.maximum(c["p_bias"], torch.where(
            p_vn0 < -0.5, -sw["p_rest"] * p_vn0, 0.0))
        if g_vr0 is not None:
            g_vn0 = torch.sum(g_vr0 * sw["g_normal"], dim=-3)
            c["g_target"] = torch.maximum(c["g_bias"], torch.where(
                g_vn0 < -0.5, -sw["g_rest"] * g_vn0, 0.0))

    def pgs(vr, nrm, t1, t2, target, kn, kt1, kt2, relax, fric, active, l0, l1, l2, ax):
        """One projected-Jacobi update of a slot grid → (impulse, dλn, dλt1, dλt2)."""
        vn = torch.sum(vr * nrm, dim=ax)
        dln = (target - vn) / kn * relax
        dln = torch.where(active, torch.clamp_min(l0 + dln, 0.0) - l0, 0.0)
        max_f = fric * (l0 + dln)
        n1 = torch.clamp(l1 + (-torch.sum(vr * t1, dim=ax) / kt1) * relax, -max_f, max_f)
        n2 = torch.clamp(l2 + (-torch.sum(vr * t2, dim=ax) / kt2) * relax, -max_f, max_f)
        d1 = torch.where(active, n1 - l1, 0.0)
        d2 = torch.where(active, n2 - l2, 0.0)
        imp = torch.where(active.unsqueeze(ax), nrm * dln.unsqueeze(ax) + t1 * d1.unsqueeze(ax)
                          + t2 * d2.unsqueeze(ax), 0.0)
        return imp, dln, d1, d2

    def apply(c, v_r, w_r, g_imp, p_imp):
        acc = 0.0
        if g_imp is not None:
            acc = -torch.sum(_six(g_imp, c["g_r"], -3), dim=-2)
        acc = acc - torch.sum(_six(p_imp, c["p_ra"], -4), dim=(-3, -2))
        acc = acc + back_sum(torch.sum(_six(p_imp, c["p_rb"], -4), dim=-3), c["K"])
        return v_r + acc[..., 0:3, :] * c["im"][..., None, :], w_r + acc[..., 3:6, :] * c["iiw"]

    def sweep_iter(c, sw, v, w, lams):
        order = c["order"]
        v_r, w_r = take_ranked(v, order), take_ranked(w, order)
        g_vr, p_vr = rel_vels(c, v_r, w_r)
        gl, gl1, gl2, pl, pl1, pl2 = lams
        g_imp = None
        if g_vr is not None:
            g_imp, g_dln, g_d1, g_d2 = pgs(g_vr, sw["g_normal"], c["g_t1"], c["g_t2"],
                                          c["g_target"], c["g_kn"], c["g_kt1"], c["g_kt2"],
                                          c["g_relax"], sw["g_fric"], sw["g_active"],
                                          gl, gl1, gl2, -3)
            gl, gl1, gl2 = gl + g_dln, gl1 + g_d1, gl2 + g_d2
        p_imp, p_dln, p_d1, p_d2 = pgs(p_vr, sw["p_normal"], c["p_t1"], c["p_t2"],
                                      c["p_target"], c["p_kn"], c["p_kt1"], c["p_kt2"],
                                      c["p_relax"], sw["p_fric"], sw["p_active"], pl, pl1, pl2,
                                      -4)
        v_r, w_r = apply(c, v_r, w_r, g_imp, p_imp)
        return (unrank(v_r, order), unrank(w_r, order),
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
                g_imp = torch.where(sw["g_active"].unsqueeze(-3), sw["g_normal"] * gl.unsqueeze(-3)
                                    + c["g_t1"] * gl1.unsqueeze(-3)
                                    + c["g_t2"] * gl2.unsqueeze(-3), 0.0)
            p_imp = torch.where(sw["p_active"].unsqueeze(-4), sw["p_normal"] * pl.unsqueeze(-4)
                                + c["p_t1"] * pl1.unsqueeze(-4) + c["p_t2"] * pl2.unsqueeze(-4),
                                0.0)
            v_r, w_r = apply(c, take_ranked(vel, order), take_ranked(angvel, order), g_imp, p_imp)
            vel, angvel = unrank(v_r, order), unrank(w_r, order)

    for _ in range(iterations):
        for i, (c, sw) in enumerate(zip(consts, sweeps)):
            vel, angvel, lams[i] = sweep_iter(c, sw, vel, angvel, lams[i])
    return vel, angvel, tuple(lams)


def solve_contacts_banded_multi(vel, angvel, inv_mass_body, iiw_body, pos_body, sweeps, dt,
                                iterations: int = 8, baumgarte: float = 0.0,
                                slop: float = 0.005, relaxation: float = 0.75, warm=None):
    """Multi-sweep projected-Jacobi PGS (body-order vel/angvel/pos/iiw
    [..., 3, NB], inverse masses [NB] or [..., NB]): each pass applies every
    sweep's banded contact block in its own rank space. `sweeps` are dicts
    with `order` (int64 [..., NB]) and the banded grids p_point/p_normal
    ([..., 3, k, K, NB]), p_depth/p_active/p_fric/p_rest ([..., k, K, NB]);
    a sweep may also carry ground grids g_* ([..., 3, G, NB] / [..., G,
    NB]). `warm`: per-sweep dicts {"p": (λn, λt1, λt2) [..., k, K, NB] in
    this frame's rank space, "g": the ground lambdas [..., G, NB]}, applied
    up front and seeding the accumulators. Returns (vel, angvel, the
    per-sweep final lambdas (gl, gl1, gl2, pl, pl1, pl2)), 0 on inactive
    slots.

    CPU tensors take the plain version (solve_contacts_banded_multi_plain);
    CUDA tensors launch the kernel csrc/banded_jacobi.cu
    (solve_contacts_banded_cuda); there is no fallback between the two."""
    if vel.device.type == "cpu":
        return solve_contacts_banded_multi_plain(vel, angvel, inv_mass_body, iiw_body, pos_body,
                                                 sweeps, dt, iterations=iterations,
                                                 baumgarte=baumgarte, slop=slop,
                                                 relaxation=relaxation, warm=warm)
    if vel.device.type == "cuda":
        return solve_contacts_banded_cuda(vel, angvel, inv_mass_body, iiw_body, pos_body, sweeps,
                                          dt, iterations=iterations, baumgarte=baumgarte,
                                          slop=slop, relaxation=relaxation, warm=warm)
    raise ValueError(f"solve_contacts_banded_multi: unsupported device {vel.device}")


# ---------------------------------------------------------------------------
# the kernel (csrc/banded_jacobi.cu)

# A sweep's world keeps the constants of its first BJ_RECORDS_PER_BODY * NB
# contacts in records; a contact past them has its constants recomputed from
# the grids where a pass uses it (the same arithmetic, so the same result).
BJ_RECORDS_PER_BODY = 16


class _BJView(ctypes.Structure):
    """banded_jacobi.cu's View: a pointer and the element strides of the axes
    (w, c, a, d, i); an axis the operand lacks has stride 0."""
    _fields_ = [("p", ctypes.c_void_p)] + [(ax, ctypes.c_longlong) for ax in "wcadi"]


_BJ_PAIR = tuple((key[2:], key) for key in PAIR_KEYS)      # (the Sweep's field, the key)
_BJ_GROUND = tuple((key, key) for key in GROUND_KEYS)


class _BJSweep(ctypes.Structure):
    """banded_jacobi.cu's Sweep: one sweep's operands."""
    _fields_ = ([("order", _BJView)] + [(f, _BJView) for f, _ in _BJ_PAIR + _BJ_GROUND]
                + [("warm_p", _BJView * 3), ("warm_g", _BJView * 3)]
                + [(f, ctypes.c_int) for f in ("ground", "warm_pairs", "warm_ground", "pad")])


class _BJCall(ctypes.Structure):
    """banded_jacobi.cu's Call: sizes, scalars, operands, outputs, workspace."""
    _fields_ = ([(f, ctypes.c_int) for f in ("W", "NB", "S", "k", "K", "G", "iterations", "cap",
                                             "dt_per_world")]
                + [(f, ctypes.c_float) for f in ("bias_scale", "baumgarte", "slop", "relaxation")]
                + [("bias_live", ctypes.c_int)]
                + [(f, _BJView) for f in ("vel", "angvel", "inv_mass", "iiw", "pos", "dt_view")]
                + [(f, ctypes.c_void_p) for f in ("sweeps", "vel_out", "angvel_out")]
                + [("lam_p", ctypes.c_void_p * 2), ("lam_g", ctypes.c_void_p),
                   ("work", ctypes.c_void_p), ("work_bytes", ctypes.c_longlong),
                   ("launches", ctypes.c_int), ("pad2", ctypes.c_int)])


def _bj_view(name: str, t, dev, dtype, batch: tuple, tail: tuple, axes: str,
             who: str = "banded jacobi") -> _BJView:
    """`t` as the kernel reads it: broadcast to batch + tail (stride 0 where
    it broadcasts; nothing is copied), the batch axes as one axis w, and the
    strides of `axes`, one letter of "cadi" per axis of `tail`. Raises on
    another device or dtype, or a shape that does not broadcast to one
    strided batch axis; `who` names the kernel in the message."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{who}: {name} must be a tensor, not {type(t).__name__}")
    if t.device != dev:
        raise ValueError(f"{who}: {name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{who}: {name} must be {dtype}, not {t.dtype}")
    try:
        flat = t.expand(batch + tail).view((math.prod(batch),) + tail)
    except RuntimeError as e:
        raise ValueError(f"{who}: {name} of shape {tuple(t.shape)} is not a strided "
                         f"{batch + tail}") from e
    strides = dict(zip("w" + axes, flat.stride()))
    return _BJView(flat.data_ptr(), *(strides.get(ax, 0) for ax in "wcadi"))


def _bj_operands(vel, angvel, inv_mass_body, iiw_body, pos_body, sweeps, dt, iterations,
                 baumgarte, slop, relaxation, warm):
    """The solve's operands checked and laid out for the kernel: (call with
    its operand views and scalars, the sweeps' array, (batch, NB, k, K,
    G)). Raises
    ValueError on what the kernel does not take: another device or dtype,
    shapes that do not broadcast, a sweep without its pair grids, sweeps of
    other k, K or G. Touches no device memory."""
    if not isinstance(vel, torch.Tensor) or vel.dim() < 2 or vel.shape[-2] != 3:
        raise ValueError("banded jacobi: vel must be [..., 3, NB]")
    dev, f32 = vel.device, torch.float32
    batch, nb = tuple(vel.shape[:-2]), vel.shape[-1]
    if not sweeps:
        raise ValueError("banded jacobi: needs at least one sweep")
    if warm is not None and len(warm) < len(sweeps):
        raise ValueError(f"banded jacobi: {len(warm)} warm entries for {len(sweeps)} sweeps")
    call = _BJCall()
    for f, t in (("vel", vel), ("angvel", angvel), ("iiw", iiw_body), ("pos", pos_body)):
        setattr(call, f, _bj_view(f, t, dev, f32, batch, (3, nb), "ci"))
    call.inv_mass = _bj_view("inv_mass", inv_mass_body, dev, f32, batch, (nb,), "i")
    k = K = G = None
    arr = (_BJSweep * len(sweeps))()
    for s, sw in enumerate(sweeps):
        missing = [key for key in ("order",) + PAIR_KEYS if key not in sw]
        ground = "g_active" in sw
        if ground:
            missing += [key for key in GROUND_KEYS if key not in sw]
        if missing:
            raise ValueError(f"banded jacobi: sweep {s} lacks {missing}")
        if sw["p_active"].dim() < 3:
            raise ValueError(f"banded jacobi: sweep {s}'s p_active is not [..., k, K, NB]")
        kK = tuple(sw["p_active"].shape[-3:-1])
        if k is None:
            k, K = kK
        elif kK != (k, K):
            raise ValueError(f"banded jacobi: sweep {s} has (k, K) = {kK}, sweep 0 {(k, K)}")
        x = arr[s]
        x.order = _bj_view(f"sweep {s} order", sw["order"], dev, torch.int64, batch, (nb,), "i")
        for f, key in _BJ_PAIR:
            vec = key in ("p_point", "p_normal")
            setattr(x, f, _bj_view(f"sweep {s} {key}", sw[key], dev,
                                   torch.bool if key == "p_active" else f32, batch,
                                   ((3,) if vec else ()) + (k, K, nb), "cadi" if vec else "adi"))
        if ground:
            if sw["g_active"].dim() < 2:
                raise ValueError(f"banded jacobi: sweep {s}'s g_active is not [..., G, NB]")
            g = sw["g_active"].shape[-2]
            if G is not None and g != G:
                raise ValueError(f"banded jacobi: sweep {s} has G = {g}, an earlier sweep {G}")
            G = g
            x.ground = 1
            for f, key in _BJ_GROUND:
                vec = key in ("g_point", "g_normal")
                setattr(x, f, _bj_view(f"sweep {s} {key}", sw[key], dev,
                                       torch.bool if key == "g_active" else f32, batch,
                                       ((3,) if vec else ()) + (G, nb), "cai" if vec else "ai"))
        w_s = warm[s] if warm is not None else None
        if not w_s:
            continue
        for key, tail, axes, flag, field in (("p", (k, K, nb), "adi", "warm_pairs", "warm_p"),
                                             ("g", (G, nb), "ai", "warm_ground", "warm_g")):
            lam = w_s.get(key)
            if lam is None or (key == "g" and not ground):
                continue
            if len(lam) != 3:
                raise ValueError(f"banded jacobi: sweep {s}'s warm {key!r} is not (λn, λt1, λt2)")
            setattr(x, flag, 1)
            for j, t in enumerate(lam):
                getattr(x, field)[j] = _bj_view(f"sweep {s} warm {key}[{j}]", t, dev, f32, batch,
                                                tail, axes)
    if isinstance(dt, torch.Tensor):
        if dt.device != dev:
            raise ValueError(f"banded jacobi: dt is on {dt.device}, expected {dev}")
        call.dt_per_world = 1
        call.dt_view = _bj_view("dt", dt, dev, f32, batch, (), "")
    elif dt > 0:
        call.bias_live, call.bias_scale = 1, baumgarte / dt
    call.W, call.NB, call.S, call.k, call.K, call.G = (math.prod(batch), nb, len(sweeps), k, K,
                                                       G or 0)
    call.iterations = max(int(iterations), 0)
    call.baumgarte, call.slop, call.relaxation = baumgarte, slop, relaxation
    return call, arr, (batch, nb, k, K, G or 0)


@functools.cache
def _bj_library():
    """The kernel library, its view of the structures checked against ours."""
    lib = native.library()
    sizes = (ctypes.c_longlong * 4)()
    lib.lumix_banded_jacobi_abi(sizes)
    ours = (ctypes.sizeof(_BJView), ctypes.sizeof(_BJSweep), ctypes.sizeof(_BJCall),
            _BJCall.launches.offset)
    if tuple(sizes) != ours:
        raise RuntimeError(f"banded_jacobi.cu's structures {tuple(sizes)} differ from the "
                           f"wrapper's {ours}")
    return lib


def solve_contacts_banded_cuda(vel, angvel, inv_mass_body, iiw_body, pos_body, sweeps, dt,
                               iterations: int = 8, baumgarte: float = 0.0, slop: float = 0.005,
                               relaxation: float = 0.75, warm=None):
    """solve_contacts_banded_multi on the card: the kernel's launches
    (csrc/banded_jacobi.cu) on the current stream, their number added to
    `.launches`. Operands are read through their strides (broadcast views
    stay views); the lambdas come back as views of one buffer."""
    dev = vel.device
    if dev.type != "cuda":
        raise ValueError(f"solve_contacts_banded_cuda takes CUDA tensors, got {dev}")
    lib = _bj_library()
    call, arr, (batch, nb, k, K, G) = _bj_operands(vel, angvel, inv_mass_body, iiw_body,
                                                   pos_body, sweeps, dt, iterations, baumgarte,
                                                   slop, relaxation, warm)
    s_n, w_n = call.S, call.W
    call.cap = min(BJ_RECORDS_PER_BODY, k * K + G) * nb
    v_out = torch.empty((2,) + batch + (3, nb), device=dev)
    lam = torch.empty((2, s_n, w_n, k, K, nb, 3), device=dev)
    lam_g = torch.empty((s_n, w_n, G, nb, 3), device=dev) if G else None
    call.work_bytes = lib.lumix_banded_jacobi_workspace(w_n, nb, s_n, k, K, G, call.cap)
    work = torch.empty(call.work_bytes, dtype=torch.uint8, device=dev)
    call.sweeps = ctypes.addressof(arr)
    call.vel_out, call.angvel_out = v_out[0].data_ptr(), v_out[1].data_ptr()
    call.lam_p[0], call.lam_p[1] = lam[0].data_ptr(), lam[1].data_ptr()
    call.lam_g = lam_g.data_ptr() if G else None
    call.work = work.data_ptr()
    rc = lib.lumix_banded_jacobi(ctypes.addressof(call), native.stream_handle(dev))
    native.check(rc, "lumix_banded_jacobi")
    solve_contacts_banded_cuda.launches += call.launches
    fin = lam[call.iterations % 2]
    zero = None
    lams = []
    for s in range(s_n):
        pl = tuple(fin[s, ..., j].view(batch + (k, K, nb)) for j in range(3))
        if arr[s].ground:
            gl = tuple(lam_g[s, ..., j].view(batch + (G, nb)) for j in range(3))
        else:
            zero = torch.zeros((), device=dev) if zero is None else zero
            gl = (zero,) * 3
        lams.append(gl + pl)
    return v_out[0], v_out[1], tuple(lams)


solve_contacts_banded_cuda.launches = 0  # kernel launches, counted where the kernel is launched


def banded_jacobi_bytes(w: int, nb: int, sweeps: int, k: int, K: int, ground_slots: int,
                        n_active: int, warm: bool = True) -> int:
    """Bytes a banded solve must move over `w` worlds of `nb` bodies, with
    `sweeps` pair grids of k x K slots a body, `ground_slots` ground slots a
    body in all, and `n_active` active contacts: every slot's active flag
    read and its three lambdas written (0 where inactive); an active slot's
    point, normal, depth, friction and restitution read (36 B), and its
    warm-start lambdas (12 B) where `warm`; per body its velocities,
    position, inverse inertia and inverse mass read (13 words), its
    velocities written (6), and its rank in each sweep read (8 B each)."""
    slots = w * nb * (sweeps * k * K + ground_slots)
    return (slots * 13 + n_active * (36 + 12 * int(warm))
            + w * nb * (19 * 4 + 8 * sweeps))


def match_warm_lams(prev_lams, prev_rank, order, K: int):
    """Carry accumulated pair impulses across frames in rank space.

    prev_lams [..., L, k, K, NB] in the previous frame's rank space (λn,
    λt1, λt2), prev_rank int32 [..., NB] the previous body → rank map (-1:
    cold), order int64 [..., NB] this frame's rank → body map. Returns
    [..., L, k, K, NB] in this frame's rank space: slot (d-1, i) holds the
    previous lambdas of the pair (order[i], order[i+d]) if it sat in the
    previous window in either orientation, else 0. A pair whose ranks
    crossed keeps λn and λt1 and flips λt2 (n' = -n gives t1' = -t1, t2' =
    t2)."""
    nb = order.shape[-1]
    r2p = take_ranked(prev_rank, order).to(torch.int64)
    r2p_safe = torch.where(r2p < 0, -(1 << 20), r2p)
    partner = banded_pair_data(r2p_safe, K)              # [.., K, NB]
    delta = partner - r2p_safe[..., None, :]
    fwd = (delta >= 1) & (delta <= K)
    bwd = (delta <= -1) & (delta >= -K)
    valid = (fwd | bwd) & (r2p[..., None, :] >= 0) & (partner >= 0)
    didx = torch.where(fwd, delta, -delta) - 1
    base = torch.where(fwd, r2p_safe[..., None, :], partner)
    flat = torch.clamp(didx * nb + base, 0, K * nb - 1)
    src = prev_lams.reshape(prev_lams.shape[:-2] + (K * nb,))
    out = take_ranked(src, flat.reshape(flat.shape[:-2] + (K * nb,))).reshape(prev_lams.shape)
    out = torch.where(valid[..., None, None, :, :], out, 0.0)
    sign = torch.where(bwd, -1.0, 1.0)[..., None, None, :, :]
    return torch.cat([out[..., 0:2, :, :, :], out[..., 2:3, :, :, :] * sign,
                      out[..., 3:, :, :, :]], dim=-4)


def project_positions_banded_multi(pos_body, sweeps, inv_mass_body, iterations: int = 3,
                                   slop: float = 0.005, relaxation: float = 0.8,
                                   max_correction: float = 0.05):
    """Multi-sweep split-impulse position projection (body-order positions
    [..., 3, NB]); the per-frame push is capped at max_correction, as in the
    reference."""
    if iterations <= 0:
        return pos_body
    body = pos_body.shape[:-2] + pos_body.shape[-1:]
    deg_body = _body_degree(sweeps, body, pos_body.device)
    im_body = inv_mass_body.expand(body)
    consts = []
    for sw in sweeps:
        order = sw["order"]
        K = sw["p_normal"].shape[-2]
        s_im = take_ranked(im_body, order)
        s_deg = take_ranked(deg_body, order)
        c = {"order": order, "K": K, "im": s_im,
             "p_k": torch.clamp_min(s_im[..., None, None, :]
                                    + banded_pair_data(s_im, K)[..., None, :, :], 1e-9),
             "p_e0": torch.where(sw["p_active"],
                                 torch.clamp(sw["p_depth"] - slop, 0.0, max_correction), 0.0),
             "p_rx": torch.clamp_max(1.6 / torch.clamp_min(torch.maximum(
                 s_deg[..., None, None, :], banded_pair_data(s_deg, K)[..., None, :, :]), 1.0),
                 relaxation)}
        if "g_active" in sw:
            c["g_k"] = torch.clamp_min(s_im[..., None, :], 1e-9)
            c["g_e0"] = torch.where(sw["g_active"],
                                    torch.clamp(sw["g_depth"] - slop, 0.0, max_correction), 0.0)
            c["g_rx"] = torch.clamp_max(1.6 / torch.clamp_min(s_deg[..., None, :], 1.0),
                                        relaxation)
        consts.append(c)

    dpos = torch.zeros_like(pos_body)
    lams = [(torch.zeros_like(sw["g_depth"]) if "g_depth" in sw else None,
             torch.zeros_like(sw["p_depth"])) for sw in sweeps]
    for _ in range(iterations):
        for i, (c, sw) in enumerate(zip(consts, sweeps)):
            order = c["order"]
            dp_r = take_ranked(dpos, order)
            gl, pl = lams[i]
            d_acc = 0.0
            if "g_k" in c:
                g_sep = torch.sum((-dp_r[..., :, None, :]) * sw["g_normal"], dim=-3)
                g_dl = (c["g_e0"] - g_sep) / c["g_k"] * c["g_rx"]
                g_dl = torch.where(sw["g_active"], torch.clamp_min(gl + g_dl, 0.0) - gl, 0.0)
                d_acc = -torch.sum(torch.where(sw["g_active"].unsqueeze(-3),
                                               sw["g_normal"] * g_dl.unsqueeze(-3), 0.0), dim=-2)
                gl = gl + g_dl
            dp_b = banded_pair_data(dp_r, c["K"])
            p_sep = torch.sum((dp_b[..., :, None, :, :] - dp_r[..., :, None, None, :])
                              * sw["p_normal"], dim=-4)
            p_dl = (c["p_e0"] - p_sep) / c["p_k"] * c["p_rx"]
            p_new = torch.clamp_min(pl + p_dl, 0.0)
            p_dl = torch.where(sw["p_active"], p_new - pl, 0.0)
            step_p = torch.where(sw["p_active"].unsqueeze(-4),
                                 sw["p_normal"] * p_dl.unsqueeze(-4), 0.0)
            d_acc = (d_acc - torch.sum(step_p, dim=(-3, -2))
                     + back_sum(torch.sum(step_p, dim=-3), c["K"]))
            dpos = unrank(dp_r + d_acc * c["im"][..., None, :], order)
            lams[i] = (gl, pl + p_dl)
    return pos_body + dpos


def _identity_sweep(grids, nb: int, device):
    """One sweep dict of rank-ordered grids whose rank space is body order."""
    return dict(grids, order=torch.arange(nb, device=device))


def solve_contacts_banded(vel, angvel, inv_mass, iiw, g_point, g_normal, g_depth, g_active,
                          g_fric, g_rest, p_point, p_normal, p_depth, p_active, p_fric, p_rest,
                          pos_rank, dt, iterations: int = 8, baumgarte: float = 0.0,
                          slop: float = 0.005, relaxation: float = 0.75):
    """Single-sweep projected-Jacobi PGS in rank space: every input is
    rank-ordered (vel/angvel/iiw/pos_rank [..., 3, NB], ground grids
    [..., (3,) G, NB], banded pair grids [..., (3,) k, K, NB], the partner
    of slot (s, d-1, i) is rank i+d). The multi-sweep solve with one sweep
    whose rank space is the input's order: the same updates in the same
    order. Returns (vel, angvel) rank-ordered."""
    sw = _identity_sweep(dict(g_point=g_point, g_normal=g_normal, g_depth=g_depth,
                              g_active=g_active, g_fric=g_fric, g_rest=g_rest, p_point=p_point,
                              p_normal=p_normal, p_depth=p_depth, p_active=p_active,
                              p_fric=p_fric, p_rest=p_rest), vel.shape[-1], vel.device)
    v, w, _ = solve_contacts_banded_multi(vel, angvel, inv_mass, iiw, pos_rank, [sw], dt,
                                          iterations=iterations, baumgarte=baumgarte, slop=slop,
                                          relaxation=relaxation)
    return v, w


def project_positions_banded(pos_rank, g_normal, g_depth, g_active, p_normal, p_depth, p_active,
                             inv_mass, iterations: int = 3, slop: float = 0.005,
                             relaxation: float = 0.8, max_correction: float = 0.05):
    """Single-sweep split-impulse position projection in rank space (the
    multi-sweep projection with one sweep in the input's order)."""
    sw = _identity_sweep(dict(g_normal=g_normal, g_depth=g_depth, g_active=g_active,
                              p_normal=p_normal, p_depth=p_depth, p_active=p_active),
                         pos_rank.shape[-1], pos_rank.device)
    return project_positions_banded_multi(pos_rank, [sw], inv_mass, iterations=iterations,
                                          slop=slop, relaxation=relaxation,
                                          max_correction=max_correction)


def cross_sweep_coverage(order_s, ranks_earlier, K: int):
    """[.., K, NB] mask: banded slot (d-1, i) of this sweep already inside
    an earlier sweep's window (rank distance <= K there); None for the first
    sweep."""
    covered = None
    for rk in ranks_earlier:
        rr = take_ranked(rk, order_s)
        c = torch.abs(banded_pair_data(rr, K) - rr[..., None, :]) <= K
        covered = c if covered is None else (covered | c)
    return covered


def banded_sweeps(pos, rot, mn, mx, orders, ranks, col_keys, shape, radius, he, dyn, occ, fric,
                  rest, K: int, k: int, any_caps: bool, ground, carry, layers, hulls):
    """The banded contact stage: each sweep's grids in its own rank space,
    as solve_contacts_banded_multi and project_positions_banded_multi take
    them.

    Body order in: pos/rot [..., 3|4, NB] and the AABBs mn/mx [..., 3, NB]
    with their world axes; orders, ranks and col_keys from sweep_orders;
    the per-body tables shape, radius, he, dyn, occ, fric and rest ([NB] /
    [3, NB], shared by the worlds). Per sweep: the analytic narrowphase
    (banded_pair_grids), the polytope SAT where a pair holds a hull
    (`hulls`: the tables poly_verts, poly_axes, poly_rad and is_convex, or
    None); the pairs that the layer matrix rules out (`layers`: the layer
    table and the flattened [L * L] matrix, or None), that join two
    non-dynamic bodies or an unoccupied one, or that an earlier sweep's
    window holds, masked; pair friction sqrt(f_a f_b), restitution
    max(r_a, r_b). Sweep 0 takes the ground stream, `ground` = (Contacts in
    body order, G slots a body; the ground's friction; the ground's
    restitution floor, or None for the body's own), or None. `carry` (last
    frame's banded_carry), or None for a cold solve, is re-matched to this
    frame's ranks (match_warm_lams).

    Returns (sweeps: dicts of "order" and the PAIR_KEYS / GROUND_KEYS grids;
    warm: the solve's per-sweep warm-start dicts, or None; miss: the
    per-step window certificate, int32 [...]: only the column sweeps
    certify, a lone classic sweep by its x-window bound; n_active: the
    active contacts, int32 [...]).

    CPU tensors take the plain version (banded_sweeps_plain); CUDA tensors
    launch the kernel csrc/banded_grids.cu (banded_sweeps_cuda), which
    raises on operands it does not take; there is no fallback between the
    two."""
    args = (pos, rot, mn, mx, orders, ranks, col_keys, shape, radius, he, dyn, occ, fric, rest, K,
            k, any_caps, ground, carry, layers, hulls)
    if pos.device.type == "cpu":
        return banded_sweeps_plain(*args)
    if pos.device.type == "cuda":
        return banded_sweeps_cuda(*args)
    raise ValueError(f"banded_sweeps: unsupported device {pos.device}")


def banded_sweeps_plain(pos, rot, mn, mx, orders, ranks, col_keys, shape, radius, he, dyn, occ,
                        fric, rest, K: int, k: int, any_caps: bool, ground, carry, layers, hulls):
    """The plain version of banded_sweeps, same contract: per sweep the
    analytic narrowphase over every slot of the [.., K, NB] window (eager
    torch, each intermediate a full grid), then the masks ANDed in."""
    batch, nb = pos.shape[:-2], pos.shape[-1]
    warm = None if carry is None else []
    sweeps = []
    miss = torch.zeros(batch, dtype=torch.int32, device=pos.device)
    n_active = torch.zeros(batch, dtype=torch.int32, device=pos.device)
    for s, (order, ck) in enumerate(zip(orders, col_keys)):
        def rk(x, _o=order):
            """A per-world row in this sweep's rank space."""
            return take_ranked(x, _o)

        def rks(x, _o=order):
            """A per-body table in this sweep's rank space."""
            return take_ranked(x.expand(batch + x.shape), _o)

        sp, sr = rk(pos), rk(rot)
        s_dyn, s_occ, s_fric, s_rest = rks(dyn), rks(occ), rks(fric), rks(rest)
        s_mn, s_mx = rk(mn), rk(mx)
        p_point, p_normal, p_depth, p_raw, ok = banded_pair_grids(
            sp, sr, rks(radius), rks(he), rks(shape), s_mn, s_mx, K, k, any_caps)
        if hulls is not None:
            # pairs with a hull take the polytope SAT instead
            verts, axes, prad, is_convex = hulls
            with profiler.block("physics.banded_hulls"):
                c_pt, c_n, c_d, c_act = banded_polytope_grids(sp, sr, rks(verts), rks(axes),
                                                              rks(prad), K, k)
            s_cvx = rks(is_convex)
            cvx_pair = s_cvx[..., None, :] | banded_pair_data(s_cvx, K)          # [.., K, NB]
            cv3 = cvx_pair[..., None, None, :, :]
            p_point = torch.where(cv3, c_pt, p_point)
            p_normal = torch.where(cv3, c_n, p_normal)
            p_depth = torch.where(cvx_pair.unsqueeze(-3), c_d, p_depth)
            p_raw = torch.where(cvx_pair.unsqueeze(-3), c_act, p_raw)
        if layers is not None:
            layer, matrix = layers
            s_layer = rks(layer)
            ok = ok & matrix[s_layer[..., None, :] * math.isqrt(matrix.shape[-1])
                             + banded_pair_data(s_layer, K)]
        ok = (ok & (s_dyn[..., None, :] | banded_pair_data(s_dyn, K))
              & s_occ[..., None, :] & banded_pair_data(s_occ, K))
        if s > 0:
            ok = ok & ~cross_sweep_coverage(order, ranks[:s], K)
        fric_b, rest_b = banded_pair_data(s_fric, K), banded_pair_data(s_rest, K)
        sw = dict(zip(PAIR_KEYS, (
            p_point, p_normal, p_depth, p_raw & ok.unsqueeze(-3),
            torch.sqrt(torch.clamp_min(s_fric[..., None, :] * fric_b, 0.0))
            .unsqueeze(-3).expand(p_depth.shape),
            torch.maximum(s_rest[..., None, :], rest_b).unsqueeze(-3).expand(p_depth.shape))),
            order=order)
        if warm is not None:
            wl = match_warm_lams(carry[0][..., s, :, :, :, :], carry[2][..., s, :], order, K)
            warm.append({"p": tuple(wl[..., j, :, :, :] for j in range(3))})
        if s == 0 and ground is not None:
            gc, g_fric, g_rest = ground
            gsl = gc.depth.shape[-1] // nb
            g_depth = rk(gc.depth.reshape(batch + (gsl, nb)))
            g_active = rk(gc.active.reshape(batch + (gsl, nb))) & s_occ[..., None, :]
            g_rest = s_rest if g_rest is None else torch.clamp_min(s_rest, g_rest)
            sw.update(zip(GROUND_KEYS, (
                rk(gc.point.reshape(batch + (3, gsl, nb))),
                rk(gc.normal.reshape(batch + (3, gsl, nb))), g_depth, g_active,
                torch.sqrt(torch.clamp_min(s_fric * g_fric, 0.0))[..., None, :]
                .expand(g_depth.shape),
                g_rest[..., None, :].expand(g_depth.shape))))
            n_active = n_active + torch.sum(g_active, dim=(-2, -1)).to(torch.int32)
            if warm is not None:
                warm[0]["g"] = tuple(rk(carry[1][..., j, :, :]) for j in range(3))
        if ck is not None:
            miss = miss + column_window_miss(s_mn, s_mx, rk(ck), K, occ=s_occ)
        elif len(orders) == 1:
            miss = miss + window_miss(s_mn, s_mx, K, occ=s_occ)
        n_active = n_active + torch.sum(sw["p_active"], dim=(-3, -2, -1)).to(torch.int32)
        sweeps.append(sw)
    return sweeps, warm, miss, n_active


# ---------------------------------------------------------------------------
# the stage's kernel (csrc/banded_grids.cu)

BG_MAX_SWEEPS = 5      # sweep_orders makes at most 5
BG_MAX_POINTS = 8      # the box-box manifold is at most a box's 8 corners


class _BGSweep(ctypes.Structure):
    """banded_grids.cu's Sweep: one sweep's operands and outputs."""
    _fields_ = ([(f, _BJView) for f in ("order", "col", "prev_lam", "prev_rank", "h_point",
                                       "h_normal", "h_depth", "h_active")]
                + [(f, ctypes.c_void_p) for f in ("point", "normal", "depth", "active", "fric",
                                                  "rest", "warm")]
                + [("window_miss", ctypes.c_int), ("pad", ctypes.c_int)])


class _BGCall(ctypes.Structure):
    """banded_grids.cu's Call: sizes, scalars, operands, outputs."""
    _fields_ = ([(f, ctypes.c_int) for f in ("W", "NB", "S", "k", "K", "G", "L", "any_caps",
                                             "warm", "ground", "hulls", "layers", "g_rest_on")]
                + [(f, ctypes.c_float) for f in ("g_fric", "g_rest")] + [("pad0", ctypes.c_int)]
                + [(f, _BJView) for f in ("pos", "rot", "mn", "mx", "shape", "radius", "he",
                                          "dyn", "occ", "fric", "rest", "layer", "cvx", "matrix")]
                + [("rank", _BJView * BG_MAX_SWEEPS)]
                + [(f, _BJView) for f in ("gc_point", "gc_normal", "gc_depth", "gc_active",
                                          "carry_g")]
                + [(f, ctypes.c_void_p) for f in ("g_point", "g_normal", "g_depth", "g_active",
                                                  "g_fric_out", "g_rest_out", "g_warm", "counts")]
                + [("launches", ctypes.c_int), ("pad1", ctypes.c_int)])


def _bg_operands(pos, rot, mn, mx, orders, ranks, col_keys, shape, radius, he, dyn, occ, fric,
                 rest, K, k, any_caps, ground, carry, layers, hulls):
    """The stage's operands checked and laid out for the kernel: (call with
    its operand views and scalars, the sweeps' array, (batch, NB, G), the
    tensors the views read that the caller does not hold). Raises
    ValueError on what the kernel does not take: another device or dtype,
    shapes that do not broadcast, sweep lists of other lengths, k outside
    1..8. Touches no device memory; the hull grids and the outputs are
    filled in by the caller."""
    who = "banded grids"
    if not isinstance(pos, torch.Tensor) or pos.dim() < 2 or pos.shape[-2] != 3:
        raise ValueError(f"{who}: pos must be [..., 3, NB]")
    dev, f32, i32 = pos.device, torch.float32, torch.int32
    batch, nb = tuple(pos.shape[:-2]), pos.shape[-1]

    def view(name, t, dtype, tail, axes, b=batch):
        return _bj_view(name, t, dev, dtype, b, tail, axes, who=who)

    n_s = len(orders)
    if not 1 <= n_s <= BG_MAX_SWEEPS or len(ranks) != n_s or len(col_keys) != n_s:
        raise ValueError(f"{who}: {n_s} orders, {len(ranks)} ranks and {len(col_keys)} column "
                         f"keys; 1 to {BG_MAX_SWEEPS} sweeps")
    if not 1 <= k <= BG_MAX_POINTS or K < 1:
        raise ValueError(f"{who}: k = {k} (1..{BG_MAX_POINTS}) and K = {K} (>= 1)")
    call, keep = _BGCall(), []
    for f, t, c in (("pos", pos, 3), ("rot", rot, 4), ("mn", mn, 3), ("mx", mx, 3),
                    ("he", he, 3)):
        setattr(call, f, view(f, t, f32, (c, nb), "ci"))
    for f, t, dtype in (("shape", shape, torch.int64), ("radius", radius, f32),
                        ("dyn", dyn, torch.bool), ("occ", occ, torch.bool), ("fric", fric, f32),
                        ("rest", rest, f32)):
        setattr(call, f, view(f, t, dtype, (nb,), "i"))
    if layers is not None:
        layer, matrix = layers
        n = matrix.shape[-1] if isinstance(matrix, torch.Tensor) and matrix.dim() == 1 else -1
        if n < 0 or math.isqrt(n) ** 2 != n:
            raise ValueError(f"{who}: the layer matrix must be a flattened [L * L]")
        call.layers, call.L = 1, math.isqrt(n)
        call.layer = view("layer", layer, torch.int64, (nb,), "i")
        call.matrix = view("matrix", matrix, torch.bool, (n,), "i", b=())
    if hulls is not None:
        call.hulls = 1
        call.cvx = view("is_convex", hulls[3], torch.bool, (nb,), "i")
    arr = (_BGSweep * n_s)()
    for s, (order, rank, ck) in enumerate(zip(orders, ranks, col_keys)):
        x = arr[s]
        x.order = view(f"sweep {s} order", order, torch.int64, (nb,), "i")
        call.rank[s] = view(f"sweep {s} ranks", rank, i32, (nb,), "i")
        if ck is not None:
            x.col = view(f"sweep {s} column keys", ck, i32, (nb,), "i")
        x.window_miss = int(ck is None and n_s == 1)
    g_n = 0
    if ground is not None:
        gc, g_fric, g_rest = ground
        g_n = gc.depth.shape[-1] // nb if isinstance(gc.depth, torch.Tensor) else -1
        if g_n < 0 or gc.depth.shape[-1] != g_n * nb:
            raise ValueError(f"{who}: the ground stream is not [..., G * NB]")
        try:
            parts = dict(gc_point=gc.point.reshape(batch + (3, g_n, nb)),
                         gc_normal=gc.normal.reshape(batch + (3, g_n, nb)),
                         gc_depth=gc.depth.reshape(batch + (g_n, nb)),
                         gc_active=gc.active.reshape(batch + (g_n, nb)))
        except (RuntimeError, AttributeError) as e:
            raise ValueError(f"{who}: the ground stream does not reshape to "
                             f"{batch} + ([3,] {g_n}, {nb})") from e
        keep += parts.values()
        for f, t in parts.items():
            vec = f in ("gc_point", "gc_normal")
            setattr(call, f, view(f, t, torch.bool if f == "gc_active" else f32,
                                  ((3,) if vec else ()) + (g_n, nb), "cai" if vec else "ai"))
        call.ground, call.G, call.g_fric = 1, g_n, float(g_fric)
        if g_rest is not None:
            call.g_rest_on, call.g_rest = 1, float(g_rest)
    if carry is not None:
        lam, glam, prev = carry
        if not (isinstance(lam, torch.Tensor) and lam.dim() >= 5 and lam.shape[-5] >= n_s
                and isinstance(prev, torch.Tensor) and prev.dim() >= 2 and prev.shape[-2] >= n_s):
            raise ValueError(f"{who}: the carry must hold [..., S, 3, k, K, NB] lambdas and "
                             f"[..., S, NB] ranks for {n_s} sweeps")
        call.warm = 1
        for s in range(n_s):
            arr[s].prev_lam = view(f"carry lambdas {s}", lam.select(-5, s), f32, (3, k, K, nb),
                                   "cadi")
            arr[s].prev_rank = view(f"carry ranks {s}", prev.select(-2, s), i32, (nb,), "i")
        if ground is not None:
            call.carry_g = view("carry ground lambdas", glam, f32, (3, g_n, nb), "cai")
    call.W, call.NB, call.S, call.k, call.K = math.prod(batch), nb, n_s, k, K
    call.any_caps = int(bool(any_caps))
    return call, arr, (batch, nb, g_n), keep


@functools.cache
def _bg_library():
    """The kernel library, its view of the structures checked against ours."""
    lib = native.library()
    sizes = (ctypes.c_longlong * 4)()
    lib.lumix_banded_grids_abi(sizes)
    ours = (ctypes.sizeof(_BJView), ctypes.sizeof(_BGSweep), ctypes.sizeof(_BGCall),
            _BGCall.launches.offset)
    if tuple(sizes) != ours:
        raise RuntimeError(f"banded_grids.cu's structures {tuple(sizes)} differ from the "
                           f"wrapper's {ours}")
    return lib


def _carve(buf, parts):
    """Views of one uint8 buffer: parts (name, dtype, shape) each at a
    256-byte boundary → {name: tensor}; with buf None, the bytes needed."""
    out, at = {}, 0
    for name, dtype, shp in parts:
        n = math.prod(shp) * dtype.itemsize
        if buf is not None:
            out[name] = buf[at:at + n].view(dtype).view(shp)
        at += -(-n // 256) * 256
    return out if buf is not None else at


def banded_sweeps_cuda(pos, rot, mn, mx, orders, ranks, col_keys, shape, radius, he, dyn, occ,
                       fric, rest, K: int, k: int, any_caps: bool, ground, carry, layers, hulls):
    """banded_sweeps on the card: one launch of csrc/banded_grids.cu a sweep
    on the current stream, their number added to `.launches`, and no sync.
    Operands are read through their strides (broadcast tables stay views);
    the grids come back as views of one buffer, in banded_sweeps' shapes
    and dtypes (p_fric and p_rest [..., 1, K, NB] expanded over k, g_fric
    and g_rest over G). Worlds with hulls have the polytope SAT's grids
    computed first in plain torch, as banded_sweeps_plain does; the kernel
    takes them for the pairs that hold a hull."""
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"banded_sweeps_cuda takes CUDA tensors, got {dev}")
    call, arr, (batch, nb, g_n), keep = _bg_operands(
        pos, rot, mn, mx, orders, ranks, col_keys, shape, radius, he, dyn, occ, fric, rest, K, k,
        any_caps, ground, carry, layers, hulls)
    lib = _bg_library()
    n_s, w_n, f32 = call.S, call.W, torch.float32
    if hulls is not None:
        verts, axes, prad, _ = hulls
        for s, order in enumerate(orders):
            def rks(x, _o=order):
                return take_ranked(x.expand(batch + x.shape), _o)

            with profiler.block("physics.banded_hulls"):
                grids = banded_polytope_grids(take_ranked(pos, order), take_ranked(rot, order),
                                              rks(verts), rks(axes), rks(prad), K, k)
            keep += grids
            for f, t in zip(("h_point", "h_normal", "h_depth", "h_active"), grids):
                vec = f in ("h_point", "h_normal")
                setattr(arr[s], f, _bj_view(f"sweep {s} {f}", t, dev,
                                            torch.bool if f == "h_active" else f32, batch,
                                            ((3,) if vec else ()) + (k, K, nb),
                                            "cadi" if vec else "adi", who="banded grids"))
    grid3, grid1, band = (n_s, w_n, 3, k, K, nb), (n_s, w_n, k, K, nb), (n_s, w_n, K, nb)
    parts = [("point", f32, grid3), ("normal", f32, grid3), ("depth", f32, grid1),
             ("fric", f32, band), ("rest", f32, band), ("active", torch.bool, grid1)]
    if call.warm:
        parts.append(("warm", f32, grid3))
    if call.ground:
        g3, g1 = (w_n, 3, g_n, nb), (w_n, g_n, nb)
        parts += [("g_point", f32, g3), ("g_normal", f32, g3), ("g_depth", f32, g1),
                  ("g_fric", f32, (w_n, nb)), ("g_rest", f32, (w_n, nb)),
                  ("g_active", torch.bool, g1)]
        if call.warm:
            parts.append(("g_warm", f32, g3))
    out = _carve(torch.empty(_carve(None, parts), dtype=torch.uint8, device=dev), parts)
    counts = torch.empty((2, w_n), dtype=torch.int32, device=dev)
    for s in range(n_s):
        for f in ("point", "normal", "depth", "active", "fric", "rest", "warm"):
            if f in out:
                setattr(arr[s], f, out[f][s].data_ptr())
    for f in ("g_point", "g_normal", "g_depth", "g_active", "g_warm"):
        if f in out:
            setattr(call, f, out[f].data_ptr())
    if call.ground:
        call.g_fric_out, call.g_rest_out = out["g_fric"].data_ptr(), out["g_rest"].data_ptr()
    call.counts = counts.data_ptr()
    rc = lib.lumix_banded_grids(ctypes.addressof(call), ctypes.addressof(arr),
                                native.stream_handle(dev))
    native.check(rc, "lumix_banded_grids")
    banded_sweeps_cuda.launches += call.launches
    grid, kk = batch + (k, K, nb), batch + (1, K, nb)
    sweeps = []
    for s, order in enumerate(orders):
        sw = dict(zip(PAIR_KEYS, (
            out["point"][s].view(batch + (3, k, K, nb)), out["normal"][s].view(batch + (3, k, K, nb)),
            out["depth"][s].view(grid), out["active"][s].view(grid),
            out["fric"][s].view(kk).expand(grid), out["rest"][s].view(kk).expand(grid))),
            order=order)
        if s == 0 and call.ground:
            g1 = batch + (g_n, nb)
            sw.update(zip(GROUND_KEYS, (
                out["g_point"].view(batch + (3, g_n, nb)), out["g_normal"].view(batch + (3, g_n, nb)),
                out["g_depth"].view(g1), out["g_active"].view(g1),
                out["g_fric"].view(batch + (1, nb)).expand(g1),
                out["g_rest"].view(batch + (1, nb)).expand(g1))))
        sweeps.append(sw)
    warm = None
    if call.warm:
        warm = [{"p": tuple(out["warm"][s, :, j].view(grid) for j in range(3))} for s in range(n_s)]
        if call.ground:
            warm[0]["g"] = tuple(out["g_warm"][:, j].view(batch + (g_n, nb)) for j in range(3))
    return sweeps, warm, counts[0].view(batch), counts[1].view(batch)


banded_sweeps_cuda.launches = 0  # kernel launches, counted where the kernel is launched


def banded_grids_bytes(w: int, nb: int, sweeps: int, k: int, K: int, ground_slots: int,
                       warm: bool = True) -> int:
    """Bytes the banded contact stage must move over `w` worlds of `nb`
    bodies, with `sweeps` pair grids of k x K slots a body and
    `ground_slots` ground slots a body on the first: every pair slot's
    point, normal, depth and flag written (29 B), and where `warm` its
    three warm-start lambdas written and last frame's read (24 B); per
    sweep and (d, i) its friction and restitution written (8 B); per body
    and sweep its order entry, position, rotation, half extents, radius,
    AABB, friction, restitution, shape, dynamics and occupancy flags and
    column key read (98 B), last frame's rank where `warm` (4 B), and the
    earlier sweeps' ranks (4 B each); each ground slot's point, normal,
    depth and flag read and written (58 B), its lambdas where `warm` (24
    B), and per body the ground friction and restitution written (8 B)."""
    slots = w * nb * sweeps * k * K
    body = w * nb * sweeps
    ground = w * nb * ground_slots
    return (slots * (29 + 24 * int(warm)) + body * (K * 8 + 98 + 4 * int(warm))
            + w * nb * sweeps * (sweeps - 1) // 2 * 4
            + ground * (58 + 24 * int(warm)) + (w * nb * 8 if ground_slots else 0))


def banded_carry(sweeps, lams, ranks, glam):
    """The warm-start carry that the next frame's banded_sweeps takes, from
    the solve's per-sweep lambdas: (the pair lambdas [..., S, 3, k, K, NB],
    each sweep's in its rank space; sweep 0's ground lambdas [..., 3, G, NB]
    in body order, or `glam` where sweep 0 holds no ground grids; the rank
    maps, int32 [..., S, NB])."""
    new_lam = torch.stack([torch.stack(lam[3:6], dim=-4) for lam in lams], dim=-5)
    if "g_active" in sweeps[0]:
        glam = unrank(torch.stack(lams[0][0:3], dim=-3), sweeps[0]["order"])
    return new_lam, glam, torch.stack(ranks, dim=-2).to(torch.int32)


def exact_window_miss(mn, mx, occ, dyn, ranks, K: int, block: int = 512,
                      min_overlap: float = 0.0):
    """The exact count of AABB-overlapping (occupied, at least one dynamic)
    pairs that no sweep's rank window holds: chunked all-pairs, row blocks
    of `block` bodies against all NB, one count per world. mn, mx [..., 3,
    NB]; occ, dyn bool [NB]; ranks: body → rank int32 [..., NB] per sweep.
    min_overlap > 0 counts only misses whose least per-axis overlap
    exceeds it (that overlap bounds the contact's depth). A diagnostic, not
    a per-step cost."""
    nb = mn.shape[-1]
    nblocks = -(-nb // block)
    pad = nblocks * block - nb
    if pad:
        mn, mx = F.pad(mn, (0, pad)), F.pad(mx, (0, pad))
        occ = torch.cat([occ, occ.new_zeros(pad)])
        dyn = torch.cat([dyn, dyn.new_zeros(pad)])
        ranks = [F.pad(r, (0, pad), value=1 << 24) for r in ranks]
    iota = torch.arange(nblocks * block, device=mn.device)
    acc = torch.zeros(mn.shape[:-2], dtype=torch.int64, device=mn.device)
    for ib in range(nblocks):
        sl = slice(ib * block, (ib + 1) * block)
        mn_r, mx_r = mn[..., sl], mx[..., sl]
        ov_amount = (torch.minimum(mx_r[..., :, :, None], mx[..., :, None, :])
                     - torch.maximum(mn_r[..., :, :, None], mn[..., :, None, :]))
        ov = torch.amin(ov_amount, dim=-3) > min_overlap            # [.., block, NB]
        upper = iota[sl][:, None] < iota[None, :]                   # j > i once per pair
        mask = ov & upper & (occ[sl][:, None] & occ[None, :]) & (dyn[sl][:, None] | dyn[None, :])
        covered = torch.zeros_like(mask)
        for r in ranks:
            covered = covered | (torch.abs(r[..., sl][..., :, None] - r[..., None, :]) <= K)
        acc = acc + torch.sum(mask & ~covered, dim=(-2, -1))
    return acc.to(torch.int32)


def make_banded_world_step(shape_np: np.ndarray, radius_np, half_extents_np, dyn_mask_np,
                           inv_mass_np, inv_inertia_body_np, friction_np, restitution_np,
                           gravity=(0.0, -9.81, 0.0), neighbors: int = 24,
                           points_per_pair: int = 4, iterations: int = 8,
                           position_iterations: int = 3, ground_y: float = 0.0,
                           lin_damping: float = 0.05, ang_damping: float = 0.05,
                           ground_friction: float = 0.6, n_sweeps: int = 1,
                           exact_miss: bool = False, warm_start: bool = False):
    """The stand-alone banded world step (the physics of
    physics_big.make_big_world_step on the banded solve), leading world
    axes allowed: step(pos, rot, vel, angvel, dt) → (pos, rot, vel, angvel,
    counters {active_contacts, sap_window_miss}).

    The sweeps of sweep_orders (n_sweeps) through banded_sweeps, every body
    occupied, no layers, no hulls, the ground's restitution the body's own;
    exact_miss puts exact_window_miss (min overlap 5 mm) in the counters in
    place of the per-step certificate. warm_start carries the contact
    impulses across frames (banded_carry): step(pos, rot, vel, angvel, dt,
    carry) → (..., counters, carry'), the cold carry from
    step.init_carry(device, batch=()). The tables move to the state's
    device on first use."""
    nb = shape_np.shape[0]
    K, k, gslots = neighbors, points_per_pair, 4
    any_caps = bool(np.any(np.asarray(shape_np) == P.SHAPE_CAPSULE))
    tables = dict(shape=(shape_np, torch.int64), radius=(radius_np, torch.float32),
                  he=(half_extents_np, torch.float32), dyn=(dyn_mask_np, torch.bool),
                  im=(inv_mass_np, torch.float32), iib=(inv_inertia_body_np, torch.float32),
                  fric=(friction_np, torch.float32), rest=(restitution_np, torch.float32),
                  gravity=(gravity, torch.float32), occ=(np.ones(nb, bool), torch.bool))
    n_s = n_sweeps if n_sweeps in (1, 2) else (5 if n_sweeps >= 5 else 4)

    @functools.lru_cache(maxsize=None)
    def on(device):
        return {name: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
                for name, (a, dt) in tables.items()}

    def init_carry(device, batch=()):
        return (torch.zeros(batch + (n_s, 3, k, K, nb), device=device),
                torch.zeros(batch + (3, gslots, nb), device=device),
                torch.full(batch + (n_s, nb), -1, dtype=torch.int32, device=device))

    def step(pos, rot, vel, angvel, dt, carry=None):
        t = on(pos.device)
        vel, angvel = P.integrate_velocities(vel, angvel, dt, t["gravity"], lin_damping,
                                             ang_damping, t["dyn"])
        mn, mx = P.world_aabb(pos, rot, t["shape"], t["radius"], t["he"])
        orders, ranks, col_keys = sweep_orders(mn, mx, t["occ"], n_sweeps)
        gc = P.ground_contacts(pos, rot, t["shape"], t["radius"], t["he"], t["dyn"],
                               ground_y=ground_y, slots_per_body=gslots)
        sweeps, warm_in, miss, n_act = banded_sweeps(
            pos, rot, mn, mx, orders, ranks, col_keys, t["shape"], t["radius"], t["he"], t["dyn"],
            t["occ"], t["fric"], t["rest"], K, k, any_caps, (gc, ground_friction, None),
            carry if warm_start else None, None, None)
        iiw_body = P.inv_inertia_world_diag(rot, t["iib"])
        vel, angvel, lams = solve_contacts_banded_multi(
            vel, angvel, t["im"], iiw_body, pos, sweeps, dt, iterations=iterations,
            baumgarte=0.0, warm=warm_in)
        pos, rot = P.integrate_positions(pos, rot, vel, angvel, dt, t["dyn"])
        pos = project_positions_banded_multi(pos, sweeps, t["im"], iterations=position_iterations)
        if exact_miss:
            miss = exact_window_miss(mn, mx, t["occ"], t["dyn"], ranks, K, min_overlap=0.005)
        counters = {"active_contacts": n_act, "sap_window_miss": miss}
        if warm_start:
            return pos, rot, vel, angvel, counters, banded_carry(sweeps, lams, ranks, None)
        return pos, rot, vel, angvel, counters

    step.init_carry = init_carry
    return step
