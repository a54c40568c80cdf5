"""Banded sweep-order helpers (counterpart of a subset of
``lumixengine_tpu/ops/physics_banded.py``): the shift views, the banded
partner views, the leading-component-axis contact frame helpers, and the
multi-offset column sweeps with their coverage certificates.

These are the pieces the slot-compacted pipeline (``physics_slots.py``)
stands on. The reference's banded world step and the banded branch of its
PhysicsModule are not ported.

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
