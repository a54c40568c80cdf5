"""The PhysicsModule's banded branch in the port against the JAX package:
the ``physics_banded`` functions it runs, each on the same seeded numpy
inputs (a soup of spheres, boxes and capsules sorted by the reference's
sweep orders), and the branch itself, 20 frames in both packages from the
reference's state after a pre-roll that brings the bodies into contact:
forced on the reference's 24-actor sphere/box/capsule scene
(``tests/test_physics_big.py::test_engine_banded_mode_matches_sap_mode``),
and picked by ``broadphase="auto"`` for a 3x3x3 block of boxes at 320 actor
slots.

Tolerances: sorts, ranks, masks, the warm-start match and the coverage mask
are data movement and compares, exactly equal. The narrowphase grids: at
2e-6 on the active slots (inactive slots hold no contact). The Jacobi solve
and the projection sum each body's impulses in another order (the port's
back_sum adds the K scatter views at once): SOLVE_ATOL. The module: the
tolerances of test_torch_physics_module.compare_physics, the window
certificate, the active-contact count and the rank carry exactly."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lumixengine_tpu.ops import physics_banded as RB
from lumixengine_tpu.ops import physics_ops as RP
from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.models import physics_scenes as PS
from lumixengine_tpu_torch.ops import physics_banded as PB
from test_torch_bridge import DT, ref_from_numpy, ref_to_numpy
from test_torch_physics_module import PH, build, compare_physics, jax_step, scene_tree

torch.set_num_threads(1)

K, KP, NB = 8, 4, 48          # window, points per pair, bodies of the soup
SOLVE_ATOL = 1e-5             # |v| ~ 1 m/s, impulses summed in another order


def _soup(seed=0):
    """Spheres, boxes and capsules packed into a 2.4 m cube above a ground at
    y = 0.3, a few of them static, random velocities and inertias."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(4, NB))
    q /= np.linalg.norm(q, axis=0)
    b = dict(pos=rng.uniform(-1.2, 1.2, (3, NB)), rot=q, shape=rng.integers(0, 3, NB),
             radius=rng.uniform(0.2, 0.45, NB), he=rng.uniform(0.2, 0.45, (3, NB)),
             vel=rng.normal(0.0, 1.0, (3, NB)), ang=rng.normal(0.0, 1.0, (3, NB)),
             iiw=rng.uniform(1.0, 6.0, (3, NB)), im=rng.uniform(0.5, 2.0, NB))
    b["pos"][1] += 1.4
    b["im"][::9] = 0.0
    b["iiw"][:, ::9] = 0.0
    b = {k: v.astype(np.int32 if k == "shape" else np.float32) for k, v in b.items()}
    j = {k: jnp.asarray(v) for k, v in b.items()}
    mn, mx = RP.world_aabb(j["pos"], j["rot"], j["shape"], j["radius"], j["he"])
    orders, ranks, _ = RB.sweep_orders(mn, mx, jnp.ones(NB, bool), 4)
    b.update(mn=np.asarray(mn), mx=np.asarray(mx), orders=[np.asarray(o) for o in orders],
             ranks=[np.asarray(r) for r in ranks])
    return b


def _ranked(b, order):
    keys = ("pos", "rot", "radius", "he", "shape", "mn", "mx")
    return [b[k][..., order] for k in keys]


def _torch(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_torch(v) for v in x)
    t = torch.from_numpy(np.array(x))
    return t.long() if t.dtype == torch.int32 else t


def _jax(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _jax(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_jax(v) for v in x)
    return jnp.asarray(x)


def _sweeps(b, seed=1):
    """The banded branch's sweep dicts for the soup, built by the reference
    (as PhysicsModule._banded_solve_multi builds them): pair grids in each
    sweep's rank space, pairs an earlier sweep holds masked out, ground grids
    on the first; and seeded warm-start lambdas for each. As numpy."""
    rng = np.random.default_rng(seed)
    j = _jax(b)
    gc = RP.ground_contacts(j["pos"], j["rot"], j["shape"], j["radius"], j["he"],
                            jnp.asarray(b["im"] > 0), ground_y=0.3, slots_per_body=4)
    sweeps, warm = [], []
    for s, order in enumerate(b["orders"]):
        p_point, p_normal, p_depth, p_raw, ok = RB.banded_pair_grids(
            *_jax(_ranked(b, order)), K, KP, any_caps=True)
        if s:
            ok = ok & ~RB.cross_sweep_coverage(jnp.asarray(order), j["ranks"][:s], K)
        sw = {"order": order, "p_point": p_point, "p_normal": p_normal, "p_depth": p_depth,
              "p_active": p_raw & ok[None], "p_fric": jnp.full(p_depth.shape, 0.5),
              "p_rest": jnp.full(p_depth.shape, 0.2)}
        w = {"p": tuple(rng.uniform(0.0, 0.2, (KP, K, NB)) * scale for scale in (1.0, 0.3, 0.3))}
        if s == 0:
            sw["g_point"] = gc.point.reshape(3, 4, NB)[..., order]
            sw["g_normal"] = gc.normal.reshape(3, 4, NB)[..., order]
            sw["g_depth"] = gc.depth.reshape(4, NB)[..., order]
            sw["g_active"] = gc.active.reshape(4, NB)[..., order]
            sw["g_fric"] = jnp.full(sw["g_depth"].shape, 0.6)
            sw["g_rest"] = jnp.zeros(sw["g_depth"].shape)
            w["g"] = tuple(rng.uniform(0.0, 0.2, (4, NB)) for _ in range(3))
        sweeps.append({k: np.asarray(v) for k, v in sw.items()})
        warm.append({k: tuple(np.asarray(x, np.float32) for x in v) for k, v in w.items()})
    return sweeps, warm


def _close(got, ref, atol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol, err_msg=what)
    return float(np.abs(got.numpy() - np.asarray(ref)).max(initial=0.0))


def check_banded_pair_grids(b):
    n_active = 0
    for order in b["orders"]:
        got = PB.banded_pair_grids(*_torch(_ranked(b, order)), K, KP, any_caps=True)
        ref = RB.banded_pair_grids(*_jax(_ranked(b, order)), K, KP, any_caps=True)
        for name, g, r in zip(("raw", "ok"), got[3:], ref[3:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        live = np.asarray(ref[3]) & np.asarray(ref[4])[None]
        n_active += int(live.sum())
        for name, g, r in zip(("point", "normal", "depth"), got[:3], ref[:3]):
            r = np.asarray(r)
            m = np.broadcast_to(live, r.shape)
            np.testing.assert_allclose(g.numpy()[m], r[m], rtol=0, atol=2e-6, err_msg=name)
    assert n_active > 20, n_active


def check_cross_sweep_coverage(b):
    covered = 0
    for s in range(1, len(b["orders"])):
        got = PB.cross_sweep_coverage(_torch(b["orders"][s]), _torch(b["ranks"][:s]), K)
        ref = RB.cross_sweep_coverage(jnp.asarray(b["orders"][s]), _jax(b["ranks"][:s]), K)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        covered += int(got.sum())
    assert covered > 0


def check_match_warm_lams(b):
    rng = np.random.default_rng(5)
    prev = rng.normal(size=(3, KP, K, NB)).astype(np.float32)
    prev_rank = b["ranks"][0].copy()
    prev_rank[::7] = -1                                   # cold bodies
    for order in b["orders"]:
        got = PB.match_warm_lams(_torch(prev), _torch(prev_rank), _torch(order), K)
        ref = RB.match_warm_lams(jnp.asarray(prev), jnp.asarray(prev_rank), jnp.asarray(order), K)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert np.count_nonzero(got.numpy()) > 0


def check_back_sum(b):
    y = np.random.default_rng(6).integers(-99, 99, (3, KP, K, NB)).astype(np.int32)
    ref = sum(RB._back(jnp.asarray(y[..., d - 1, :]), d) for d in range(1, K + 1))
    np.testing.assert_array_equal(PB.back_sum(_torch(y), K).numpy(), np.asarray(ref))


def check_solve_contacts_banded_multi(b):
    sweeps, warm = _sweeps(b)
    args = ("vel", "ang", "im", "iiw", "pos")
    errs = []
    for w in (warm, None):
        got = PB.solve_contacts_banded_multi(*_torch([b[k] for k in args]), _torch(sweeps), DT,
                                             iterations=10, warm=_torch(w))
        ref = RB.solve_contacts_banded_multi(*_jax([b[k] for k in args]), _jax(sweeps), DT,
                                             iterations=10, warm=_jax(w), return_lams=True)
        errs.append(_close(got[0], ref[0], SOLVE_ATOL, "vel"))
        errs.append(_close(got[1], ref[1], SOLVE_ATOL, "angvel"))
        for s, (gl, rl) in enumerate(zip(got[2], ref[2])):
            for i, (g, r) in enumerate(zip(gl, rl)):
                if g.dim():
                    errs.append(_close(g, r, SOLVE_ATOL, f"sweep {s} lambda {i}"))
    moved = np.abs(np.asarray(ref[0]) - b["vel"]).max()
    assert moved > 0.1, moved
    print("solve_contacts_banded_multi max abs err", max(errs))


def check_project_positions_banded_multi(b):
    sweeps, _ = _sweeps(b)
    got = PB.project_positions_banded_multi(_torch(b["pos"]), _torch(sweeps), _torch(b["im"]))
    ref = RB.project_positions_banded_multi(jnp.asarray(b["pos"]), _jax(sweeps),
                                            jnp.asarray(b["im"]))
    err = _close(got, ref, 1e-6, "pos")
    assert np.abs(np.asarray(ref) - b["pos"]).max() > 1e-3
    print("project_positions_banded_multi max abs err", err)


CHECKS = {f.__name__[len("check_"):]: f for f in (
    check_banded_pair_grids, check_cross_sweep_coverage, check_match_warm_lams, check_back_sum,
    check_solve_contacts_banded_multi, check_project_positions_banded_multi)}


@pytest.mark.parametrize("fn", list(CHECKS))
def test_banded_function_matches_reference(fn):
    CHECKS[fn](_soup())


# -- the PhysicsModule's banded branch --------------------------------------------------

def mixed24(pkg):
    """The reference's banded-vs-SAP scene: 24 dynamic boxes, spheres and
    capsules dropped in a column, 32 actor slots, the banded branch forced
    (its default sweeps, window and warm start)."""
    engine, world, _ = build(pkg, actors=32)
    rng = np.random.default_rng(9)
    for i in range(24):
        p = rng.uniform(-3, 3, 2)
        e = world.create_entity(position=(float(p[0]), 1.0 + 0.6 * i, float(p[1])))
        world.create_component(e, "rigid_actor", motion="dynamic",
                               shape=["box", "sphere", "capsule"][i % 3],
                               half_extents=(0.4, 0.4, 0.4), radius=0.35, mass=1.0)
    pm = world.modules["physics"]
    pm.broadphase = "banded"
    pm.invalidate_statics()
    return engine, world, {}


def block27(pkg):
    """PS.box_block(27, 320) in either package: `auto` picks banded."""
    engine, world, _ = build(pkg, actors=320, joints=1)
    rng = np.random.default_rng(0)
    grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3)
    for p in grid * 1.1 + rng.uniform(0, 0.05, (27, 3)) + [0.0, 2.0, 0.0]:
        e = world.create_entity(position=tuple(float(x) for x in p.astype(np.float32)))
        world.create_component(e, "rigid_actor", motion="dynamic", shape="box",
                               half_extents=(0.5, 0.5, 0.5), mass=1.0, friction=0.6)
    return engine, world, {}


# spec, pre-roll frames, the broadphase option
BANDED = {"mixed24_forced": (mixed24, 70, "banded"), "block27_auto": (block27, 50, "auto")}


@pytest.mark.parametrize("name", list(BANDED))
def test_banded_branch_matches_reference(name, monkeypatch):
    """20 frames in both packages from the reference's state after the
    pre-roll, compared after every frame; the window certificate 0."""
    spec, pre, option = BANDED[name]
    rengine, rworld, pengine, pworld, tree = scene_tree(spec)
    pm = pworld.modules["physics"]
    assert pm.broadphase == option and pm.statics().sap
    rstep = jax_step(rengine, rworld, monkeypatch)
    rstate = ref_from_numpy(rworld.device_state(), tree)
    for _ in range(pre):
        rstate = rstep(rstate, jnp.float32(DT))
    pstate = bridge.state_from_numpy(ref_to_numpy(rstate), "cpu")
    pstep = pengine.build_step(pworld, "cpu")
    errs, active, carried = {}, [], 0
    for f in range(20):
        rstate = rstep(rstate, jnp.float32(DT))
        pstate = pstep(pstate, DT)
        got, ref = bridge.state_to_numpy(pstate), ref_to_numpy(rstate)
        compare_physics(got, ref, errs, where=f" (frame {pre + f + 1})")
        assert int(got[PH + "counters.sap_window_miss"]) == 0
        active.append(int(got[PH + "counters.active_contacts"]))
        carried = max(carried, np.count_nonzero(got[PH + "sap_lam"]))
    assert carried > 0, "no pair contact carried a warm start"
    assert (got[PH + "sap_rank"] >= 0).all()
    print(f"{name}: frames {pre + 1}..{pre + 20}, active contacts {min(active)}..{max(active)},"
          f" max abs err", {k: f"{v:.2e}" for k, v in errs.items() if v})


def test_box_block_is_the_auto_scene():
    """The block chip_smoke.py drives builds the test's scene, and picks the
    banded branch by its actor capacity alone."""
    _e, world = PS.box_block(27, 320)
    _e2, world2, _ = block27("torch")
    got = bridge.state_to_numpy(world.device_state("cpu"))
    want = bridge.state_to_numpy(world2.device_state("cpu"))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pm = world.modules["physics"]
    assert pm.broadphase == "auto" and pm.statics().sap
    _e, small = PS.box_block(27, 256)
    assert not small.modules["physics"].statics().sap


def test_banded_world_batch_steps_each_world():
    """A batch of two worlds through the banded branch: each world comes
    out as it does stepped alone."""
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    engine, world, _ = mixed24("torch")
    step = engine.build_step(world, "cpu")
    batch = replicate_state(world.device_state("cpu"), 2, torch.Generator().manual_seed(0))
    for _ in range(30):
        batch = step(batch, DT)
    fields = ("pos", "rot", "vel", "angvel", "sap_lam", "sap_glam", "sap_rank")
    for i in range(2):
        alone = replicate_state(world.device_state("cpu"), 2, torch.Generator().manual_seed(0))
        alone = bridge.state_from_numpy(
            {k: v[i] for k, v in bridge.state_to_numpy(alone).items()}, "cpu")
        for _ in range(30):
            alone = step(alone, DT)
        bm, am = batch.modules["physics"], alone.modules["physics"]
        for f in fields:
            torch.testing.assert_close(getattr(bm, f)[i], getattr(am, f), rtol=0, atol=0,
                                       msg=f)
    assert int(bm.counters["active_contacts"].min()) > 0
