"""The slot-compacted rigid-body pipeline of the port
(``ops/physics_banded.py`` subset, ``ops/physics_slots.py``) against the JAX
package, on the same numpy inputs, and the reference's property tests run on
the port.

Tolerances: the banded views, sweep orders, ranks, column keys and window
certificates are data movement, sorts and compares — exactly equal.
build_slots: per-body partner SETS and all certificates equal (a 1-ulp
difference in the SAT bound may move a candidate by one 0.12 mm priority
step, which can reorder slots but not change the set). The step: 5 frames
from the reference's state at frame 25 of the 64-box drop (contacts active,
warm start live): pos/rot POS_ATOL, vel/angvel and λ VEL_ATOL, counters and
the sleep carry exactly equal; and 10 steps of the 10k-box drop from a
state at step 1200 saved on the card, at the same tolerances."""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu.ops import physics_banded as RB
from lumixengine_tpu.ops import physics_ops as RP
from lumixengine_tpu.ops import physics_slots as RS
from lumixengine_tpu_torch.models import demo_scenes as pds
from lumixengine_tpu_torch.ops import physics_banded as PB
from lumixengine_tpu_torch.ops import physics_ops as PP
from lumixengine_tpu_torch.ops import physics_slots as PS

torch.set_num_threads(1)

DT = 1.0 / 60.0
POS_ATOL = 1e-4
VEL_ATOL = 1e-3
SLOT_KW = dict(slots=16, window=16)


def _mats(nb, half=0.5, fric=0.6, rest=0.0):
    return (np.full(nb, RP.SHAPE_BOX, np.int32), np.full(nb, half, np.float32),
            np.full((3, nb), half, np.float32), np.ones(nb, bool), np.ones(nb, np.float32),
            np.full((3, nb), 6.0, np.float32), np.full(nb, fric, np.float32),
            np.full(nb, rest, np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------- banded views

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_shift_and_banded_views_exact(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 2, 37)) * 100).astype(dtype)
    for d in (0, 1, 5, 36, 37, 50):
        np.testing.assert_array_equal(_n(PB._fwd(_t(x), d)), np.asarray(RB._fwd(jnp.asarray(x), d)))
        np.testing.assert_array_equal(_n(PB._back(_t(x), d)),
                                      np.asarray(RB._back(jnp.asarray(x), d)))
        np.testing.assert_array_equal(_n(PS._back_fill(_t(x), d, -7)),
                                      np.asarray(RS._back_fill(jnp.asarray(x), d, -7)))
    for K in (1, 4, 16, 40):
        got = PB.banded_pair_data(_t(x), K)
        assert got.shape == (3, 2, K, 37)
        np.testing.assert_array_equal(_n(got), np.asarray(RB.banded_pair_data(jnp.asarray(x), K)))


def _aabbs(nb, seed, dead=0):
    """AABBs of a tumbled-box soup centred on the origin (negative x/z
    centres, so negative column cells), some minimum-y ties, and `dead`
    unoccupied slots."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-6, 6, (3, nb)).astype(np.float32)
    pos[1] = np.round(pos[1] * 2) / 2                  # equal min-y within columns
    q = rng.normal(size=(4, nb)).astype(np.float32)
    q /= np.linalg.norm(q, axis=0)
    q[:, ::3] = [[0], [0], [0], [1]]
    he = rng.uniform(0.2, 0.6, (3, nb)).astype(np.float32)
    shape = np.full(nb, RP.SHAPE_BOX, np.int32)
    shape[::7] = RP.SHAPE_SPHERE
    radius = he[0].copy()
    mn, mx = RP.world_aabb(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(shape),
                           jnp.asarray(radius), jnp.asarray(he))
    occ = np.ones(nb, bool)
    occ[rng.choice(nb, dead, replace=False)] = False
    return np.asarray(mn), np.asarray(mx), occ, (pos, q, he, shape)


@pytest.mark.parametrize("n_sweeps", [1, 2, 4, 5])
def test_sweep_orders_and_window_certificates_exact(n_sweeps):
    mn, mx, occ, _ = _aabbs(300, seed=n_sweeps, dead=13)
    ro, rr, rk = RB.sweep_orders(jnp.asarray(mn), jnp.asarray(mx), jnp.asarray(occ), n_sweeps)
    po, pr, pk = PB.sweep_orders(_t(mn), _t(mx), _t(occ), n_sweeps)
    assert len(po) == len(ro) == {1: 1, 2: 2, 4: 4, 5: 5}[n_sweeps]
    negative = 0
    for s in range(len(ro)):
        np.testing.assert_array_equal(_n(po[s]), np.asarray(ro[s]))
        np.testing.assert_array_equal(_n(pr[s]), np.asarray(rr[s]))
        assert pr[s].dtype == torch.int32
        assert (pk[s] is None) == (rk[s] is None)
        order = np.asarray(ro[s])
        s_mn, s_mx, s_occ = mn[:, order], mx[:, order], occ[order]
        for K in (2, 8, 40):
            if rk[s] is None:
                ref = RB.window_miss(jnp.asarray(s_mn), jnp.asarray(s_mx), K,
                                     occ=jnp.asarray(s_occ))
                got = PB.window_miss(_t(s_mn), _t(s_mx), K, occ=_t(s_occ))
            else:
                col = np.asarray(rk[s])[order]
                ref = RB.column_window_miss(jnp.asarray(s_mn), jnp.asarray(s_mx),
                                            jnp.asarray(col), K, occ=jnp.asarray(s_occ))
                got = PB.column_window_miss(_t(s_mn), _t(s_mx), _t(col), K, occ=_t(s_occ))
            assert int(got) == int(ref), (s, K)
        if rk[s] is not None:
            np.testing.assert_array_equal(_n(pk[s]), np.asarray(rk[s]))
            assert pk[s].dtype == torch.int32
            negative += int((np.asarray(rk[s]) < 0).sum())
    assert n_sweeps == 1 or negative > 0        # negative qx wrapped into the key


# ---------------------------------------------------------------- build_slots

def _pile_aabbs():
    """A 4³ pile in contact: lattice pitch 0.98 m for unit boxes, slightly
    tumbled."""
    rng = np.random.default_rng(7)
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = (g * 0.98 + rng.uniform(0, 0.01, (64, 3)) + [0, 0.5, 0]).T.astype(np.float32)
    q = np.concatenate([rng.normal(scale=0.02, size=(3, 64)), np.ones((1, 64))]).astype(
        np.float32)
    q /= np.linalg.norm(q, axis=0)
    return pos, q, 16, 16


def _soup(seed):
    """The reference's tumbled-box soups: 128 boxes in a 6 m cube."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 6, (3, 128)).astype(np.float32)
    q = rng.normal(size=(4, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=0)
    return pos, q, 24, 24


@functools.lru_cache(maxsize=None)
def _ref_build_slots(window, slots):
    return jax.jit(functools.partial(RS.build_slots, n_sweeps=4, window=window, slots=slots,
                                     slop=0.005))


@pytest.mark.parametrize("case", [f"soup{s}" for s in range(6)] + ["pile"])
def test_build_slots_matches_reference(case):
    pos, q, window, slots = _pile_aabbs() if case == "pile" else _soup(int(case[4:]))
    nb = pos.shape[-1]
    he = np.full((3, nb), 0.5, np.float32)
    radius = np.full(nb, 0.5, np.float32)
    shape = np.full(nb, RP.SHAPE_BOX, np.int32)
    occ, dyn = np.ones(nb, bool), np.ones(nb, bool)
    mn, mx = RP.world_aabb(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(shape),
                           jnp.asarray(radius), jnp.asarray(he))
    mn, mx = np.asarray(mn), np.asarray(mx)
    rpart, rcert = _ref_build_slots(window, slots)(
        jnp.asarray(mn), jnp.asarray(mx), jnp.asarray(occ), jnp.asarray(dyn),
        sat_prune=(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(he),
                   jnp.asarray(shape == RP.SHAPE_BOX)))
    ppart, pcert = PS.build_slots(_t(mn), _t(mx), _t(occ), _t(dyn), 4, window, slots,
                                  slop=0.005, sat_prune=(_t(pos), _t(q), _t(he),
                                                         _t(shape == RP.SHAPE_BOX)))
    assert ppart.dtype == torch.int32 and ppart.shape == (slots, nb)
    for key in ("slot_drop", "column_miss", "max_candidates"):
        assert int(pcert[key]) == int(rcert[key]), key
    rp, pp = np.asarray(rpart), ppart.numpy()
    for i in range(nb):
        assert set(pp[:, i][pp[:, i] >= 0]) == set(rp[:, i][rp[:, i] >= 0]), i
    n_pairs = int((pp >= 0).sum())
    print(f"{case}: {n_pairs} directed slots, max candidates {int(pcert['max_candidates'])},"
          f" slot order identical {np.array_equal(pp, rp)}")
    assert n_pairs > 0


# ---------------------------------------------------------------- the step

def _drop_start(nb=64, side=4, lift=1.0, seed=1):
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)[:nb]
    rng = np.random.default_rng(seed)
    pos = (g * 1.1 + rng.uniform(0, 0.05, (nb, 3)) + [0, lift, 0]).T.astype(np.float32)
    rot = np.zeros((4, nb), np.float32)
    rot[3] = 1.0
    return pos, rot, np.zeros((3, nb), np.float32), np.zeros((3, nb), np.float32)


@functools.lru_cache(maxsize=None)
def _reference_at(frames: int = 25):
    """The reference's jitted step of the 64-box drop and its (body state,
    carry) after `frames` frames, as numpy."""
    step = RS.make_slot_world_step(*_mats(64), **SLOT_KW)
    stepj = jax.jit(step)
    body = tuple(jnp.asarray(a) for a in _drop_start())
    carry = step.init_carry()
    for _ in range(frames):
        *body, _ctr, carry = stepj(*body, jnp.float32(DT), carry)
    return stepj, tuple(np.asarray(a) for a in body), tuple(np.asarray(a) for a in carry)


def _match_lams(lam, partner, ref_lam, ref_partner):
    """The port's λ [3, k, P, NB] re-ordered into the reference's slot order
    by partner id (-1 slots take 0)."""
    out = np.zeros_like(ref_lam)
    for i in range(partner.shape[-1]):
        where = {int(p): s for s, p in enumerate(partner[:, i]) if p >= 0}
        for s, p in enumerate(ref_partner[:, i]):
            if p >= 0:
                out[:, :, s, i] = lam[:, :, where[int(p)], i]
    return out


def test_five_steps_match_reference():
    stepj, body, carry = _reference_at()
    step = PS.make_slot_world_step(*_mats(64), **SLOT_KW)
    consts = step.init_consts("cpu")
    rbody, rcarry = tuple(jnp.asarray(a) for a in body), tuple(jnp.asarray(a) for a in carry)
    pbody, pcarry = tuple(_t(a) for a in body), tuple(_t(a) for a in carry)
    errs, slots_same, active = {}, [], []
    for _ in range(5):
        *rbody, rctr, rcarry = stepj(*rbody, jnp.float32(DT), rcarry)
        *pbody, pctr, pcarry = step(*pbody, torch.tensor(DT, dtype=torch.float32), pcarry,
                                    consts)
        for name, r, p, atol in zip(("pos", "rot", "vel", "angvel"), rbody, pbody,
                                    (POS_ATOL, POS_ATOL, VEL_ATOL, VEL_ATOL)):
            errs[name] = max(errs.get(name, 0.0), float(np.abs(_n(p) - np.asarray(r)).max()))
            np.testing.assert_allclose(_n(p), np.asarray(r), rtol=0, atol=atol, err_msg=name)
        for key in rctr:
            assert int(pctr[key]) == int(rctr[key]), key
        rpart, ppart = np.asarray(rcarry[1]), _n(pcarry[1])
        slots_same.append(bool(np.array_equal(rpart, ppart)))
        for i in range(64):
            assert set(ppart[:, i]) == set(rpart[:, i]), i
        for name, j in (("lam", 0), ("ground lam", 2)):
            p = _n(pcarry[j])
            if j == 0:
                p = _match_lams(p, ppart, np.asarray(rcarry[0]), rpart)
            errs[name] = max(errs.get(name, 0.0), float(np.abs(p - np.asarray(rcarry[j])).max()))
            np.testing.assert_allclose(p, np.asarray(rcarry[j]), rtol=0, atol=VEL_ATOL,
                                       err_msg=name)
        for j in (3, 4, 5):
            np.testing.assert_array_equal(_n(pcarry[j]), np.asarray(rcarry[j]))
        active.append(int(pctr["active_contacts"]))
    print(f"active contacts {active}, slot order identical {slots_same}, max abs err {errs}")
    assert min(active) > 0 and int(pctr["max_candidates"]) > 0
    assert np.abs(carry[0]).max() > 0              # the warm start carried impulses in


# ---------------------------------------------------------------- properties

def _run(step, body, frames, carry=None, consts=None):
    consts = consts or step.init_consts("cpu")
    body = tuple(_t(a) for a in body)
    carry = carry or step.init_carry("cpu")
    drop = miss = 0
    dt = torch.tensor(DT, dtype=torch.float32)
    for _ in range(frames):
        *body, ctr, carry = step(*body, dt, carry, consts)
        drop += int(ctr["slot_drop"])
        miss += int(ctr["column_miss"])
    return body, carry, drop, miss


def test_two_body_momentum_exact():
    """Both directed copies compute bitwise-identical Δλ, so a zero-gravity
    collision conserves linear momentum."""
    step = PS.make_slot_world_step(*_mats(2), gravity=(0, 0, 0), slots=4, window=4,
                                   ground_y=-100.0, lin_damping=0.0, ang_damping=0.0)
    pos = np.array([[-0.6, 0.45], [0.0, 0.1], [0.0, 0.05]], np.float32)
    rot = np.zeros((4, 2), np.float32)
    rot[3] = 1.0
    vel = np.array([[2.0, -2.0], [0.0, 0.0], [0.0, 0.0]], np.float32)
    (pos, _r, vel, _w), _c, _d, _m = _run(step, (pos, rot, vel, np.zeros((3, 2), np.float32)),
                                          30)
    np.testing.assert_allclose(vel.sum(dim=1).numpy(), 0.0, atol=1e-4)
    assert torch.isfinite(pos).all() and float(vel[0, 0]) < 2.0   # they did collide


def test_small_pile_settles_with_clean_certificates():
    """4³ pile drop: 240 frames, rests on the ground at about slop depth, the
    certificates never fire."""
    step = PS.make_slot_world_step(*_mats(64), **SLOT_KW)
    (pos, _r, vel, _w), _c, drop, miss = _run(step, _drop_start(), 240)
    assert drop == 0 and miss == 0
    assert float(pos[1].min()) > 0.5 - 0.012
    assert float(vel.abs().max()) < 0.5


def test_sleep_entry_gated_on_ground_depth():
    """A body may not doze off while more than 4 cm into the ground; a body
    resting at slop depth sleeps."""
    step = PS.make_slot_world_step(*_mats(2), slots=4, window=4, sleep_speed=0.15,
                                   sleep_frames=5, lin_damping=0.0, ang_damping=0.0)
    consts = step.init_consts("cpu")
    body = (np.array([[0.0, 3.0], [0.495, 0.42], [0.0, 0.0]], np.float32),
            np.array([[0, 0], [0, 0], [0, 0], [1, 1]], np.float32),
            np.zeros((3, 2), np.float32), np.zeros((3, 2), np.float32))
    body, carry = tuple(_t(a) for a in body), step.init_carry("cpu")
    first_sleep_y = [None, None]
    for _ in range(12):
        *body, _ctr, carry = step(*body, torch.tensor(DT), carry, consts)
        for b in range(2):
            if first_sleep_y[b] is None and int(carry[3][b]) >= 5:
                first_sleep_y[b] = float(body[0][1, b])
    assert first_sleep_y[0] is not None and first_sleep_y[0] > 0.49
    assert first_sleep_y[1] is None or first_sleep_y[1] > 0.46, first_sleep_y
    assert float(body[0][1, 1]) > 0.455


def test_static_bodies_and_spheres_mix():
    """Spheres resting on a static box slab: mixed shapes and static bodies
    go through candidate discovery (AABB-scored for non-box pairs)."""
    nb = 5
    shape = np.array([RP.SHAPE_BOX] + [RP.SHAPE_SPHERE] * 4, np.int32)
    he = np.zeros((3, nb), np.float32)
    he[:, 0] = [4.0, 0.25, 4.0]
    step = PS.make_slot_world_step(
        shape, np.full(nb, 0.5, np.float32), he, np.array([False, True, True, True, True]),
        np.array([0.0, 1, 1, 1, 1], np.float32),
        np.tile(np.array([[0.0, 2.5, 2.5, 2.5, 2.5]], np.float32), (3, 1)),
        np.full(nb, 0.5, np.float32), np.zeros(nb, np.float32), slots=8, window=8,
        ground_y=-10.0)
    pos = np.zeros((3, nb), np.float32)
    pos[1, 0] = 2.0                            # slab top at y = 2.25
    pos[0, 1:] = [-1.0, 0.0, 1.0, 0.3]
    pos[1, 1:] = 4.0
    pos[2, 1:] = [0.0, 0.5, -0.5, 1.2]
    rot = np.zeros((4, nb), np.float32)
    rot[3] = 1.0
    (pos, _r, vel, _w), _c, _d, _m = _run(step, (pos, rot, np.zeros((3, nb), np.float32),
                                                 np.zeros((3, nb), np.float32)), 200)
    assert bool((pos[1, 1:] > 2.25 + 0.5 - 0.02).all()), pos[1]
    assert abs(float(pos[1, 0]) - 2.0) < 1e-6
    assert float(vel.abs().max()) < 0.2


def test_capsules_are_refused():
    """Capsules are no longer refused: the narrowphase the slot pipeline
    runs takes them through its capsule arm, as the reference does, here on
    a capsule beside a capsule and beside a box, on either side."""
    x = torch.zeros(3, 2)
    xb = torch.tensor([[0.45, -0.45], [0.0, 0.5], [0.0, 0.1]])
    q = torch.tensor([[0.0, 0], [0, 0], [0, 0], [1, 1]])
    r = torch.full((2,), 0.25)
    he = torch.full((3, 2), 0.4)
    for shape_b in (PP.SHAPE_CAPSULE, PP.SHAPE_BOX):
        sa = torch.full((2,), PP.SHAPE_CAPSULE, dtype=torch.int64)
        sb = torch.full((2,), shape_b, dtype=torch.int64)
        got = PP.pair_contacts_from_data(x, q, r, he, sa, xb, q, r, he, sb, any_caps=True)
        ref = RP.pair_contacts_from_data(*(jnp.asarray(t.numpy()) for t in (
            x, q, r, he, sa.int(), xb, q, r, he, sb.int())), any_caps=True)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
        assert bool(got[3].any())
        m = np.asarray(ref[3])
        for g, w in zip(got[:3], ref[:3]):
            w = np.asarray(w)
            keep = np.broadcast_to(m, w.shape)
            np.testing.assert_allclose(g.numpy()[keep], w[keep], rtol=0, atol=1e-6)


def test_box_drop_pile_is_the_bench_scene():
    """box_drop_pile builds the reference bench's scene: the lattice, the
    jitter draws and the published tier."""
    step, (pos, rot, vel, ang, carry), consts = pds.box_drop_pile(100, device="cpu")
    rng = np.random.default_rng(0)
    g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"), -1).reshape(-1, 3)[:100]
    want = (g * 1.1 + rng.uniform(0, 0.05, (100, 3)) + [0.0, 2.0, 0.0]).T.astype(np.float32)
    np.testing.assert_array_equal(pos.numpy(), want)
    assert float(rot[3].min()) == 1.0 and not vel.any() and not ang.any()
    assert carry[0].shape == (3, 4, 28, 100) and consts["iib"].unique().tolist() == [6.0]
    (pos, _r, _v, _w), _c, drop, miss = _run(step, (pos, rot, vel, ang), 40, carry, consts)
    assert drop == 0 and miss == 0 and float(pos[1].min()) > 0.4


def test_sinking_boxes_match_reference_at_10k():
    """The port's 10k-box drop at step 1200 on an H100 (tests/data, made by
    tools/dump_box_state.py): awake boxes under sleeping ones lie below the
    reference's 0.47 m bound and sink. 10 steps of the JAX package and of the
    port from that state agree, and sink the lowest box by the same amount:
    the sinking is the reference's algorithm, not a fault of the port."""
    z = np.load(os.path.join(os.path.dirname(__file__), "data", "boxes_step1200.npz"))
    assert int(z["steps"]) == 1200 and int(z["slot_drop"]) == 0 and int(z["column_miss"]) == 0
    body = tuple(z[k] for k in ("pos", "rot", "vel", "angvel"))
    carry = tuple(z[f"carry{i}"] for i in range(6))
    nb = body[0].shape[-1]
    y0 = body[0][1]
    low = int(np.argmin(y0))
    assert nb == 10_000 and int((y0 < 0.47).sum()) >= 20 and y0[low] < 0.3
    stepj = jax.jit(RS.make_slot_world_step(*_mats(nb), **pds.BOX_DROP_TIER))
    step = PS.make_slot_world_step(*_mats(nb), **pds.BOX_DROP_TIER)
    consts = step.init_consts("cpu")
    rbody, rcarry = tuple(jnp.asarray(a) for a in body), tuple(jnp.asarray(a) for a in carry)
    pbody, pcarry = tuple(_t(a) for a in body), tuple(_t(a) for a in carry)
    errs = {}
    for _ in range(10):
        *rbody, rctr, rcarry = stepj(*rbody, jnp.float32(DT), rcarry)
        *pbody, pctr, pcarry = step(*pbody, torch.tensor(DT, dtype=torch.float32), pcarry,
                                    consts)
        for name, r, p, atol in zip(("pos", "rot", "vel", "angvel"), rbody, pbody,
                                    (POS_ATOL, POS_ATOL, VEL_ATOL, VEL_ATOL)):
            errs[name] = max(errs.get(name, 0.0), float(np.abs(_n(p) - np.asarray(r)).max()))
            np.testing.assert_allclose(_n(p), np.asarray(r), rtol=0, atol=atol, err_msg=name)
        for key in ("active_contacts", "sleeping", "slot_drop", "column_miss"):
            assert int(pctr[key]) == int(rctr[key]), key
    sink_ref = y0[low] - float(rbody[0][1, low])
    sink_port = y0[low] - float(pbody[0][1, low])
    print(f"lowest box {low}: {y0[low]:.6f} m, sinks {sink_ref:.4e} m (JAX) and {sink_port:.4e} m"
          f" (port) in 10 steps; max abs err {errs}")
    assert sink_ref > 1e-3 and abs(sink_port - sink_ref) < 1e-5


@pytest.mark.slow
def test_box_drop_cubic_slots():
    """The 10³ cubic pile at the bench's published tier (slots 24) comes to
    rest: certificates zero throughout, bounded penetration, KE < 50 and over
    90% asleep by frame 540. The reference's gate also bounds the lowest
    centre by 0.47 m at frame 360, which holds in its recorded TPU run only:
    on the CPU the JAX package reads 0.4692 m there and the port 0.4602 m,
    one awake box still landing on the settling pile, the only box below
    0.47 m (it rises above 0.6 m over the next 10 frames, in both packages).
    So here at most 2 boxes lie below 0.47 m, every box above 0.44 m, and
    every sleeping box above 0.41 m: a box falls asleep only after its
    ground depth read at most 8·slop (4 cm) at the start of the frame
    before, whose position pass moves it at most max_correction (4 cm)
    more, less a centimetre for its velocity."""
    nb = 1000
    step = PS.make_slot_world_step(*_mats(nb), slots=24, window=40, iterations=6,
                                   position_iterations=2, over_relax=1.4,
                                   settle_damping=0.05, sleep_speed=0.15, sleep_frames=15,
                                   wake_speed=0.3)
    consts = step.init_consts("cpu")
    body, carry, drop, miss = _run(step, _drop_start(nb, side=10, lift=2.0, seed=0), 30,
                                   consts=consts)
    assert abs(float(body[2][0].sum())) < 1e-2
    body, carry, d2, m2 = _run(step, body, 330, carry, consts)
    assert drop + d2 == 0 and miss + m2 == 0
    y = body[0][1]
    asleep = (body[2] ** 2).sum(0) + (body[3] ** 2).sum(0) == 0.0
    assert float(y[asleep].min()) > 0.41 and float(y.min()) > 0.44 and float(y.max()) < 11.0
    assert int((y < 0.47).sum()) <= 2
    body, carry, d3, m3 = _run(step, body, 180, carry, consts)
    assert d3 == 0 and m3 == 0
    v, w = body[2].numpy(), body[3].numpy()
    assert float((v ** 2).sum() + (w ** 2).sum()) < 50.0
    assert int(((v ** 2).sum(0) + (w ** 2).sum(0) == 0.0).sum()) > 0.9 * nb
