"""The slot pipeline's classic tier in the port (``ops/physics_slots.py``):
``build_slots`` with the classic min-x sweep (n_sweeps 1), two column
sweeps (2) and the classic sweep beside the four column sweeps (5), and
``make_slot_world_step`` with warm start, mass splitting or sleeping off,
with one sweep, and with all four at once, against the JAX package on the
scenes of tests/test_physics_slots.py, step by step.

Tolerances as tests/test_torch_slots.py's: build_slots' per-body partner
sets and certificates equal; the step's pos/rot within POS_ATOL (1e-4),
vel/angvel and the carried λ within VEL_ATOL (1e-3), its counters and the
sleep carry equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu.ops import physics_ops as RP
from lumixengine_tpu.ops import physics_slots as RS
from lumixengine_tpu_torch.ops import physics_slots as PS
from test_torch_slots import (DT, POS_ATOL, SLOT_KW, VEL_ATOL, _drop_start, _match_lams, _mats, _n,
                              _pile_aabbs, _soup, _t)

torch.set_num_threads(1)

CLASSIC = {"one_sweep": dict(n_sweeps=1), "two_sweeps": dict(n_sweeps=2),
           "five_sweeps": dict(n_sweeps=5), "cold": dict(warm_start=False),
           "jacobi": dict(mass_split=False), "awake": dict(sleeping=False),
           "all_off": dict(n_sweeps=1, warm_start=False, mass_split=False, sleeping=False)}


@pytest.mark.parametrize("n_sweeps", [1, 2, 5])
@pytest.mark.parametrize("case", ["soup0", "soup3", "pile"])
def test_build_slots_classic_sweeps_match_reference(case, n_sweeps):
    pos, q, window, slots = _pile_aabbs() if case == "pile" else _soup(int(case[4:]))
    nb = pos.shape[-1]
    he = np.full((3, nb), 0.5, np.float32)
    radius = np.full(nb, 0.5, np.float32)
    shape = np.full(nb, RP.SHAPE_BOX, np.int32)
    occ, dyn = np.ones(nb, bool), np.ones(nb, bool)
    mn, mx = RP.world_aabb(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(shape),
                           jnp.asarray(radius), jnp.asarray(he))
    mn, mx = np.asarray(mn), np.asarray(mx)
    for sat in (False, True):
        ref_sat = ((jnp.asarray(pos), jnp.asarray(q), jnp.asarray(he),
                    jnp.asarray(shape == RP.SHAPE_BOX)) if sat else None)
        rpart, rcert = RS.build_slots(jnp.asarray(mn), jnp.asarray(mx), jnp.asarray(occ),
                                      jnp.asarray(dyn), n_sweeps, window, slots, slop=0.005,
                                      sat_prune=ref_sat)
        ppart, pcert = PS.build_slots(_t(mn), _t(mx), _t(occ), _t(dyn), n_sweeps, window, slots,
                                      slop=0.005, sat_prune=(
                                          (_t(pos), _t(q), _t(he), _t(shape == RP.SHAPE_BOX))
                                          if sat else None))
        assert ppart.dtype == torch.int32 and ppart.shape == (slots, nb)
        for key in ("slot_drop", "column_miss", "max_candidates"):
            assert int(pcert[key]) == int(rcert[key]), (key, sat)
        rp, pp = np.asarray(rpart), ppart.numpy()
        for i in range(nb):
            assert set(pp[:, i][pp[:, i] >= 0]) == set(rp[:, i][rp[:, i] >= 0]), (i, sat)
        assert (pp >= 0).sum() > 0


def test_one_sweep_counts_its_window_misses():
    """The classic sweep alone certifies its x-window (window_miss): a window
    too narrow for the soup's x-density counts misses, as in the JAX
    package; beside column sweeps it adds nothing."""
    pos, q, _w, _s = _soup(1)
    nb = pos.shape[-1]
    shape = np.full(nb, RP.SHAPE_BOX, np.int32)
    mn, mx = RP.world_aabb(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(shape),
                           jnp.full(nb, 0.5), jnp.full((3, nb), 0.5))
    mn, mx, occ = np.asarray(mn), np.asarray(mx), np.ones(nb, bool)
    got = {s: int(PS.build_slots(_t(mn), _t(mx), _t(occ), _t(occ), s, 2, 4)[1]["column_miss"])
           for s in (1, 5)}
    ref = {s: int(RS.build_slots(jnp.asarray(mn), jnp.asarray(mx), jnp.asarray(occ),
                                 jnp.asarray(occ), s, 2, 4)[1]["column_miss"]) for s in (1, 5)}
    assert got == ref
    assert got[1] > 0


def _reference_run(option, frames):
    """The JAX step of the 64-box drop with `option`, jitted, and its
    (body, carry) after `frames` frames, as numpy."""
    step = RS.make_slot_world_step(*_mats(64), **SLOT_KW, **option)
    stepj = jax.jit(step)
    body = tuple(jnp.asarray(a) for a in _drop_start())
    carry = step.init_carry()
    for _ in range(frames):
        *body, _ctr, carry = stepj(*body, jnp.float32(DT), carry)
    return stepj, tuple(np.asarray(a) for a in body), tuple(np.asarray(a) for a in carry)


@pytest.mark.parametrize("name", list(CLASSIC))
def test_classic_step_matches_reference(name):
    """5 steps from the JAX step's own state at frame 25 of the 64-box drop
    (the boxes landing: contacts active), step by step."""
    option = CLASSIC[name]
    stepj, body, carry = _reference_run(option, 25)
    step = PS.make_slot_world_step(*_mats(64), **SLOT_KW, **option)
    consts = step.init_consts("cpu")
    rbody, rcarry = tuple(jnp.asarray(a) for a in body), tuple(jnp.asarray(a) for a in carry)
    pbody, pcarry = tuple(_t(a) for a in body), tuple(_t(a) for a in carry)
    errs, active = {}, []
    for _ in range(5):
        *rbody, rctr, rcarry = stepj(*rbody, jnp.float32(DT), rcarry)
        *pbody, pctr, pcarry = step(*pbody, torch.tensor(DT, dtype=torch.float32), pcarry, consts)
        for f, r, p, atol in zip(("pos", "rot", "vel", "angvel"), rbody, pbody,
                                 (POS_ATOL, POS_ATOL, VEL_ATOL, VEL_ATOL)):
            errs[f] = max(errs.get(f, 0.0), float(np.abs(_n(p) - np.asarray(r)).max()))
            np.testing.assert_allclose(_n(p), np.asarray(r), rtol=0, atol=atol, err_msg=f)
        for key in rctr:
            assert int(pctr[key]) == int(rctr[key]), key
        rpart, ppart = np.asarray(rcarry[1]), _n(pcarry[1])
        for i in range(64):
            assert set(ppart[:, i]) == set(rpart[:, i]), i
        lam = _match_lams(_n(pcarry[0]), ppart, np.asarray(rcarry[0]), rpart)
        np.testing.assert_allclose(lam, np.asarray(rcarry[0]), rtol=0, atol=VEL_ATOL, err_msg="lam")
        np.testing.assert_allclose(_n(pcarry[2]), np.asarray(rcarry[2]), rtol=0, atol=VEL_ATOL,
                                   err_msg="ground lam")
        for j in (3, 4, 5):
            np.testing.assert_array_equal(_n(pcarry[j]), np.asarray(rcarry[j]))
        active.append(int(pctr["active_contacts"]))
    print(f"{name}: active contacts {active}, max abs err {errs}")
    assert min(active) > 0
    if not option.get("sleeping", True):
        assert int(pctr["sleeping"]) == 0 and not _n(pcarry[3]).any()


@pytest.mark.parametrize("name", ["jacobi", "all_off"])
def test_classic_step_from_rest_matches_reference(name):
    """tests/test_physics_slots.py's static slab with spheres resting on it
    (mixed shapes and a static body), 40 steps from the start, step by step."""
    nb = 5
    shape = np.array([RP.SHAPE_BOX] + [RP.SHAPE_SPHERE] * 4, np.int32)
    radius = np.full(nb, 0.5, np.float32)
    he = np.zeros((3, nb), np.float32)
    he[:, 0] = [4.0, 0.25, 4.0]
    dyn = np.array([False, True, True, True, True])
    im = np.array([0.0, 1, 1, 1, 1], np.float32)
    iib = np.tile(np.array([[0.0, 2.5, 2.5, 2.5, 2.5]], np.float32), (3, 1))
    mats = (shape, radius, he, dyn, im, iib, np.full(nb, 0.5, np.float32), np.zeros(nb, np.float32))
    kw = dict(slots=8, window=8, ground_y=-10.0, **CLASSIC[name])
    rstep = RS.make_slot_world_step(*mats, **kw)
    pstep = PS.make_slot_world_step(*mats, **kw)
    pos = np.zeros((3, nb), np.float32)
    pos[1, 0] = 2.0
    pos[0, 1:] = [-1.0, 0.0, 1.0, 0.3]
    pos[1, 1:] = 2.95
    pos[2, 1:] = [0.0, 0.5, -0.5, 1.2]
    rot = np.zeros((4, nb), np.float32)
    rot[3] = 1.0
    zeros = np.zeros((3, nb), np.float32)
    rbody = tuple(jnp.asarray(a) for a in (pos, rot, zeros, zeros))
    pbody = tuple(_t(a) for a in (pos, rot, zeros, zeros))
    rcarry, pcarry = rstep.init_carry(), pstep.init_carry("cpu")
    consts = pstep.init_consts("cpu")
    stepj = jax.jit(rstep)
    touched = 0
    for _ in range(40):
        *rbody, rctr, rcarry = stepj(*rbody, jnp.float32(DT), rcarry)
        *pbody, pctr, pcarry = pstep(*pbody, torch.tensor(DT, dtype=torch.float32), pcarry, consts)
        for f, r, p, atol in zip(("pos", "rot", "vel", "angvel"), rbody, pbody,
                                 (POS_ATOL, POS_ATOL, VEL_ATOL, VEL_ATOL)):
            np.testing.assert_allclose(_n(p), np.asarray(r), rtol=0, atol=atol, err_msg=f)
        assert int(pctr["active_contacts"]) == int(rctr["active_contacts"])
        touched = max(touched, int(pctr["active_contacts"]))
    assert touched > 0
    assert abs(float(pbody[0][1, 0]) - 2.0) < 1e-6             # the slab never moves


@pytest.mark.parametrize("name", ["one_sweep", "cold", "jacobi", "awake", "all_off"])
def test_classic_two_body_momentum(name):
    """tests/test_physics_slots.py's zero-gravity collision under each classic
    option: both directed copies compute the same Δλ, so momentum is kept."""
    step = PS.make_slot_world_step(*_mats(2), gravity=(0, 0, 0), slots=4, window=4,
                                   ground_y=-100.0, lin_damping=0.0, ang_damping=0.0,
                                   **CLASSIC[name])
    pos = _t(np.array([[-0.6, 0.45], [0.0, 0.1], [0.0, 0.05]], np.float32))
    rot = torch.zeros((4, 2))
    rot[3] = 1.0
    vel = _t(np.array([[2.0, -2.0], [0.0, 0.0], [0.0, 0.0]], np.float32))
    ang = torch.zeros((3, 2))
    carry, consts = step.init_carry("cpu"), step.init_consts("cpu")
    dt = torch.tensor(DT, dtype=torch.float32)
    for _ in range(30):
        pos, rot, vel, ang, _ctr, carry = step(pos, rot, vel, ang, dt, carry, consts)
    np.testing.assert_allclose(vel.sum(dim=1).numpy(), 0.0, atol=1e-4)
    assert torch.isfinite(pos).all() and float(vel[0, 0]) < 2.0
