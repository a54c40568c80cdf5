"""The port's large-world physics against the JAX package on the CPU:
``physics_big`` (sap_pairs, the dynamic solve and projection,
make_big_world_step), ``physics_banded``'s single-sweep functions,
exact_window_miss and make_banded_world_step, the PhysicsModule's
``broadphase="sap"`` branch, and the banded branch batched over worlds.
Scenes from models/physics_scenes.py, built by both packages (the JAX
package's classes passed in) or as numpy tables.

Tolerances:
- sap_pairs: the candidate pairs, their overlap mask and the miss counts
  equal; exact_window_miss equal.
- The dynamic solve and projection on one contact set: DYN_ATOL (the port
  sums each body's impulses in another order than the reference's
  segment_sum).
- The stand-alone steps, 20 steps at 256 boxes (make_big_world_step;
  make_banded_world_step warm at 1 and 4 sweeps, cold at 1 sweep, the
  reference's default, and with exact_miss on both pipelines): positions
  and rotations within STEP_POS_ATOL, velocities within STEP_VEL_ATOL,
  counters equal.
  Run free from the JAX test's start (falling), and in lockstep on a pile
  dropped from 0.5 m (each step from the reference's own state). Where a
  lockstep step breaks them, the reference's eager step from the same
  state must hold them: XLA's CPU jit fuses multiply-adds, and its jitted
  and eager steps part at a few contact decisions.
- The module's sap branch, 30 frames at W=2: the tolerances of
  test_torch_game_physics, breaks explained as ties
  (physics_scenes.explain_break); sap against banded on the port alone at
  the JAX test's SAP_BANDED_ATOL.
- The batched banded branch at W=3: each world within BATCH_ATOL of the
  world stepped alone, ranks and counters equal; against the JAX package
  under vmap within STEP_POS_ATOL / STEP_VEL_ATOL."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.models import physics_scenes as PS
from lumixengine_tpu_torch.ops import physics_banded as PBD
from lumixengine_tpu_torch.ops import physics_big as PB
from lumixengine_tpu_torch.ops import physics_ops as PP
from test_torch_bridge import DT, ref_from_numpy, ref_to_numpy
from test_torch_game_physics import BODY_POS_ATOL, BODY_VEL_ATOL, gap, jax_api

torch.set_num_threads(2)

DYN_ATOL = 1e-5
STEP_POS_ATOL, STEP_VEL_ATOL = 1e-5, 1e-4
SAP_BANDED_ATOL = 5e-2     # tests/test_physics_big.py: banded vs sap after 90 frames
BATCH_ATOL = 1e-6
SAP_PRE = 70               # frames of the reference before the compare: the column lands
PH = PS.PH


def _soup(nb=48, seed=0, batch=()):
    """Spheres, boxes and capsules in a 3 m cube, random rotations."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=batch + (4, nb))
    q /= np.linalg.norm(q, axis=-2, keepdims=True)
    return dict(pos=rng.uniform(-1.5, 1.5, batch + (3, nb)).astype(np.float32),
                rot=q.astype(np.float32), shape=rng.integers(0, 3, nb).astype(np.int32),
                radius=rng.uniform(0.2, 0.45, nb).astype(np.float32),
                he=rng.uniform(0.2, 0.45, (3, nb)).astype(np.float32))


def _aabbs(b):
    from lumixengine_tpu.ops import physics_ops as RP

    f = functools.partial(RP.world_aabb, shape=jnp.asarray(b["shape"]),
                          radius=jnp.asarray(b["radius"]), half_extents=jnp.asarray(b["he"]))
    if b["pos"].ndim == 3:
        return jax.vmap(lambda p, r: f(p, r))(jnp.asarray(b["pos"]), jnp.asarray(b["rot"]))
    return f(jnp.asarray(b["pos"]), jnp.asarray(b["rot"]))


@pytest.mark.parametrize("batch", [(), (3,)])
def test_sap_pairs_match_reference(batch):
    from lumixengine_tpu.ops import physics_big as RB

    b = _soup(batch=batch)
    mn, mx = _aabbs(b)
    fn = functools.partial(RB.sap_pairs, neighbors=8, return_miss_count=True)
    ref = (jax.vmap(fn) if batch else fn)(jnp.asarray(b["pos"]), mn, mx)
    got = PB.sap_pairs(torch.tensor(b["pos"]), torch.tensor(np.asarray(mn)),
                       torch.tensor(np.asarray(mx)), neighbors=8, return_miss_count=True)
    for name, g, r in zip(("pair_a", "pair_b", "ok", "miss"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert int(got[2].sum()) > 10 and int(got[3].sum()) > 0


def _contact_set(seed=0):
    """One contact set of the reference's sap pipeline on the soup: the
    ground stream then the window pairs, as make_big_world_step builds it
    (numpy)."""
    from lumixengine_tpu.ops import physics_big as RB
    from lumixengine_tpu.ops import physics_ops as RP

    b = _soup(seed=seed)
    b["pos"][1] += 1.3
    nb = b["pos"].shape[-1]
    j = {k: jnp.asarray(v) for k, v in b.items()}
    mn, mx = RP.world_aabb(j["pos"], j["rot"], j["shape"], j["radius"], j["he"])
    pa, pb, ok = RB.sap_pairs(j["pos"], mn, mx, 8)
    c = RP.pair_contacts(j["pos"], j["rot"], j["shape"], j["radius"], j["he"], pa, pb)
    g = RP.ground_contacts(j["pos"], j["rot"], j["shape"], j["radius"], j["he"],
                           jnp.ones(nb, bool), ground_y=0.3)
    rng = np.random.default_rng(seed + 1)
    out = dict(point=np.concatenate([g.point, c.point], -1),
               normal=np.concatenate([g.normal, c.normal], -1),
               depth=np.concatenate([g.depth, c.depth], -1),
               active=np.concatenate([g.active, c.active & np.tile(ok, 4)], -1),
               body_a=np.concatenate([g.body_a, c.body_a]).astype(np.int64),
               body_b=np.concatenate([np.zeros(4 * nb, np.int64), c.body_b]),
               has_b=np.concatenate([np.zeros(4 * nb), np.ones(c.body_a.shape[-1])]).astype(
                   np.float32))
    c_n = out["point"].shape[-1]
    out.update(friction=rng.uniform(0.3, 0.8, c_n).astype(np.float32),
               restitution=rng.uniform(0.0, 0.5, c_n).astype(np.float32),
               pos=b["pos"], vel=rng.normal(0, 1, (3, nb)).astype(np.float32),
               ang=rng.normal(0, 1, (3, nb)).astype(np.float32),
               im=rng.uniform(0.5, 2.0, nb).astype(np.float32),
               iiw=rng.uniform(1.0, 6.0, (3, nb)).astype(np.float32), nb=nb)
    return out


def test_dynamic_solve_and_projection_match_reference():
    from lumixengine_tpu.ops import physics_big as RB

    c = _contact_set()
    nb = c["nb"]
    assert int(c["active"][4 * nb:].sum()) > 10 and int(c["active"][:4 * nb].sum()) > 5
    t = {k: torch.tensor(v) for k, v in c.items() if k != "nb"}
    j = {k: jnp.asarray(v) for k, v in c.items() if k != "nb"}
    plans = PB.contact_plans(t["body_a"], t["body_b"], t["has_b"], nb, 4 + 8 * 4, 8 * 4)
    args = ("pos", "vel", "ang", "im", "iiw", "point", "normal", "depth", "active", "body_a",
            "body_b", "has_b", "friction", "restitution")
    got = PB.solve_contacts_dynamic(*(t[k] for k in args), DT, plans, iterations=10)
    ref = RB.solve_contacts_dynamic(*(j[k] for k in args), DT, iterations=10)
    errs = [float(np.abs(g.numpy() - np.asarray(r)).max()) for g, r in zip(got, ref)]
    assert max(errs) <= DYN_ATOL, errs
    assert np.abs(np.asarray(ref[0]) - c["vel"]).max() > 0.1
    pargs = ("pos", "normal", "depth", "active", "body_a", "body_b", "has_b", "im")
    gp = PB.project_positions_dynamic(*(t[k] for k in pargs), plans, iterations=3)
    rp = RB.project_positions_dynamic(*(j[k] for k in pargs), iterations=3)
    err = float(np.abs(gp.numpy() - np.asarray(rp)).max())
    assert err <= DYN_ATOL and np.abs(np.asarray(rp) - c["pos"]).max() > 1e-3, err
    print("dynamic solve max abs err", max(errs), "projection", err)


def test_segment_plan_sums_each_body():
    """The fixed-width plan against a plain scatter-add, slots without a
    body left out, batched."""
    rng = np.random.default_rng(3)
    idx = torch.tensor(rng.integers(0, 10, (2, 60)))
    keep = torch.tensor(rng.random((2, 60)) > 0.3)
    x = torch.tensor(rng.normal(size=(2, 3, 60)).astype(np.float32))
    plan = PB.segment_plan(idx, 10, 60, keep=keep)
    want = torch.zeros(2, 3, 11).scatter_add_(
        -1, torch.where(keep, idx, 10).unsqueeze(-2).expand(2, 3, 60), x)[..., :10]
    torch.testing.assert_close(PB.segment_sum(x, plan), want, rtol=0, atol=1e-5)


# -- the stand-alone steps ----------------------------------------------------------

# kind -> make_banded_world_step's (n_sweeps, warm_start, exact_miss); None: the dynamic step.
# "banded1_cold" is the reference's default (the single-sweep step of
# test_banded_step_matches_dynamic_step); the exact_miss cases put
# exact_window_miss in the counters, on the single-sweep and the multi-sweep step.
STEPS = {"big": None, "banded1": (1, True, False), "banded4": (4, True, False),
         "banded1_cold": (1, False, False), "banded1_cold_exact": (1, False, True),
         "banded4_exact": (4, True, True)}


def _steps(kind, nb=256):
    from lumixengine_tpu.ops import physics_banded as RBD
    from lumixengine_tpu.ops import physics_big as RB

    tables = PS.box_pile_tables(nb)
    if STEPS[kind] is None:
        return (RB.make_big_world_step(*tables, **PS.PILE_STEP),
                PB.make_big_world_step(*tables, **PS.PILE_STEP), None)
    ns, warm, exact = STEPS[kind]
    kw = dict(PS.PILE_STEP, n_sweeps=ns, warm_start=warm, exact_miss=exact)
    ref = RBD.make_banded_world_step(*tables, **kw)
    return ref, PBD.make_banded_world_step(*tables, **kw), (ref.init_carry() if warm else None)


def _both(ref_step, port_step, rstate, carry):
    """One step of each package from the reference's state `rstate`."""
    pin = [torch.tensor(np.asarray(x)) for x in rstate]
    if carry is None:
        return ref_step(*rstate, jnp.float32(DT)), port_step(*pin, torch.tensor(DT))
    pc = tuple(torch.tensor(np.asarray(x)) for x in carry)
    return ref_step(*rstate, jnp.float32(DT), carry), port_step(*pin, torch.tensor(DT), pc)


def _step_gap(ro, po):
    pos = max(float(np.abs(np.asarray(r) - p.numpy()).max()) for r, p in zip(ro[:2], po[:2]))
    vel = max(float(np.abs(np.asarray(r) - p.numpy()).max()) for r, p in zip(ro[2:4], po[2:4]))
    if len(ro) == 6:
        vel = max([vel] + [float(np.abs(np.asarray(r) - p.numpy()).max())
                           for r, p in zip(ro[5][:2], po[5][:2])])
        np.testing.assert_array_equal(po[5][2].numpy(), np.asarray(ro[5][2]))
    for k in ("active_contacts", "sap_window_miss"):
        assert int(po[4][k]) == int(ro[4][k]), (k, int(po[4][k]), int(ro[4][k]))
    return pos, vel


@pytest.mark.parametrize("kind", list(STEPS))
def test_stand_alone_step_matches_reference(kind):
    ref_eager, port_step, carry0 = _steps(kind)
    ref_step = jax.jit(ref_eager)
    z = np.zeros((3, 256), np.float32)
    # free from the JAX test's start: 20 steps of the fall
    pos, rot = PS.elongated_pile(256)
    rstate, pstate = [jnp.asarray(x) for x in (pos, rot, z, z)], None
    rc = pc = carry0
    if carry0 is not None:
        pc = tuple(torch.tensor(np.asarray(x)) for x in carry0)
    pstate = [torch.tensor(x) for x in (pos, rot, z, z)]
    for _ in range(PS.PILE_FALL_STEPS):
        if rc is None:
            ro, po = ref_step(*rstate, jnp.float32(DT)), port_step(*pstate, torch.tensor(DT))
        else:
            ro = ref_step(*rstate, jnp.float32(DT), rc)
            po = port_step(*pstate, torch.tensor(DT), pc)
            rc, pc = ro[5], po[5]
        rstate, pstate = list(ro[:4]), list(po[:4])
        e_pos, e_vel = _step_gap(ro, po)
        assert e_pos <= STEP_POS_ATOL and e_vel <= STEP_VEL_ATOL, (e_pos, e_vel)
    # lockstep on a pile dropped from 0.5 m, through its landing
    pos, rot = PS.elongated_pile(256, lift=0.5)
    rstate, rc = [jnp.asarray(x) for x in (pos, rot, z, z)], carry0
    worst, explained, active = [0.0, 0.0], [], 0
    for i in range(PS.PILE_FALL_STEPS):
        ro, po = _both(ref_step, port_step, rstate, rc)
        e = _step_gap(ro, po)
        if not (e[0] <= STEP_POS_ATOL and e[1] <= STEP_VEL_ATOL):
            eager = ref_eager(*rstate, jnp.float32(DT), *(() if rc is None else (rc,)))
            e = _step_gap(eager, po)
            assert e[0] <= STEP_POS_ATOL and e[1] <= STEP_VEL_ATOL, (i, e)
            explained.append(i + 1)
        worst = [max(a, b) for a, b in zip(worst, e)]
        active = max(active, int(ro[4]["active_contacts"]))
        rstate, rc = list(ro[:4]), (ro[5] if rc is not None else None)
    assert active > 500, active
    print(f"{kind}: lockstep max abs err pos {worst[0]:.2e} vel {worst[1]:.2e}; steps held "
          f"to the eager reference {explained}")


def test_exact_window_miss_matches_reference():
    """The chunked all-pairs count on the JAX test's dense grid (5³ boxes at
    0.98 m: a lone x-sweep drops contacts, the four column sweeps none),
    with a block that does not divide the bodies."""
    from lumixengine_tpu.ops import physics_banded as RBD
    from lumixengine_tpu.ops import physics_ops as RP

    n = 5
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), 0).reshape(3, -1)
    pos = (g * 0.98 + 0.49).astype(np.float32)
    nb = pos.shape[-1]
    rot = np.tile(np.array([[0.0], [0.0], [0.0], [1.0]], np.float32), (1, nb))
    he, shape, rad = np.full((3, nb), 0.5, np.float32), np.ones(nb, np.int32), np.full(nb, .87,
                                                                                         np.float32)
    mn, mx = RP.world_aabb(*(jnp.asarray(x) for x in (pos, rot, shape, rad, he)))
    occ, dyn = np.ones(nb, bool), np.arange(nb) % 5 != 0
    counts = []
    for ns, K in ((1, 8), (4, 16)):
        _o, ranks, _c = RBD.sweep_orders(mn, mx, jnp.asarray(occ), ns)
        ref = RBD.exact_window_miss(mn, mx, jnp.asarray(occ), jnp.asarray(dyn), ranks, K,
                                    block=48)
        got = PBD.exact_window_miss(torch.tensor(np.asarray(mn)), torch.tensor(np.asarray(mx)),
                                    torch.tensor(occ), torch.tensor(dyn),
                                    [torch.tensor(np.asarray(r)) for r in ranks], K, block=48)
        assert int(got) == int(ref)
        counts.append(int(got))
    assert counts[0] > 0 and counts[1] == 0, counts


# -- the PhysicsModule's sap branch ---------------------------------------------------


def _mixed(api, broadphase, **kw):
    return PS.mixed_column(api, broadphase=broadphase, **kw)


def test_sap_branch_matches_reference(monkeypatch):
    """The 24-actor mixed column under broadphase="sap" (window 23) through
    Engine.build_step at W=2 (diverging worlds), 30 frames in both
    packages from the reference's state after SAP_PRE frames; every break
    explained as a tie or a flipped decision."""
    from lumixengine_tpu.parallel.mesh import replicate_state as ref_replicate

    rsc, psc = _mixed(jax_api(), "sap"), _mixed(None, "sap")
    pm = psc.world.modules["physics"]
    assert pm.statics().sap and not pm.statics().banded
    single = ref_to_numpy(rsc.world.device_state())
    own = bridge.state_to_numpy(psc.world.device_state("cpu"))
    assert set(own) == set(single)
    for k, v in own.items():
        assert (v.dtype, v.shape) == (single[k].dtype, single[k].shape), k
    tree = ref_to_numpy(ref_replicate(rsc.world.device_state(), 2, jax.random.PRNGKey(4)))
    rstep_raw = rsc.engine.build_step(rsc.world, jit=False)
    rstep = jax.jit(jax.vmap(rstep_raw, in_axes=(0, None)))
    pstep = psc.engine.build_step(psc.world, "cpu")
    rstate = ref_from_numpy(jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (2,) + x.shape), rsc.world.device_state()), tree)
    for _ in range(SAP_PRE):      # the column lands
        rstate = rstep(rstate, jnp.float32(DT))
    pstate = bridge.state_from_numpy(ref_to_numpy(rstate), "cpu")
    flips, worst, active = [], {}, 0
    for f in range(30):
        before = ref_to_numpy(rstate)
        rnext = rstep(rstate, jnp.float32(DT))
        pnext = pstep(pstate, DT)
        got, ref = bridge.state_to_numpy(pnext), ref_to_numpy(rnext)
        errs, broke = gap(got, ref)
        if broke is not None:
            drift = max(gap(bridge.state_to_numpy(pstate), before)[0].values())
            start = bridge.state_from_numpy(before, "cpu")
            cause, margin, errs = PS.explain_break(
                pstep, start, ref, gap, drift, pm, lambda: _ref_sap_contacts(rsc, rstate))
            flips.append((f + 1, cause, margin))
            pnext, got = bridge.state_from_numpy(ref, "cpu"), ref
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0.0), v)
        active = max(active, int(got[PH + "counters.active_contacts"].max()))
        assert (got[PH + "counters.sap_window_miss"] == 0).all()
        rstate, pstate = rnext, pnext
    assert active > 10, active
    print("sap: flips", flips, "max abs err", {k.replace(PH, ""): f"{v:.2e}"
                                               for k, v in worst.items() if v})


def _ref_sap_contacts(rsc, rstate):
    """The reference's sap contact set (point, normal, depth, active) of
    the frame from `rstate` (vmapped over its worlds): the operands its
    dynamic solve gets."""
    import lumixengine_tpu.ops.physics_big as RB

    step = rsc.engine.build_step(rsc.world, jit=False)

    def one(state):
        cap, real = {}, RB.solve_contacts_dynamic

        def record(*args, **kw):
            cap["c"] = args[5:9]
            return real(*args, **kw)

        RB.solve_contacts_dynamic = record
        try:
            step(state, jnp.float32(DT))
        finally:
            RB.solve_contacts_dynamic = real
        return cap["c"]

    return tuple(np.asarray(x) for x in jax.jit(jax.vmap(one))(rstate))


def test_sap_branch_agrees_with_banded():
    """The JAX test's like-for-like check on the port alone: the mixed
    column for 90 frames under sap and under banded (one classic sweep,
    the same window, no warm start), within SAP_BANDED_ATOL."""
    out = {}
    for bp in ("sap", "banded"):
        sc = _mixed(None, bp)
        sc.world.modules["physics"].warm_starting = False
        step = sc.engine.build_step(sc.world, "cpu")
        s = sc.world.device_state("cpu")
        for _ in range(90):
            s = step(s, DT)
        out[bp] = s.modules["physics"].pos.numpy()
    assert np.isfinite(out["banded"]).all()
    np.testing.assert_allclose(out["banded"], out["sap"], rtol=0, atol=SAP_BANDED_ATOL)


def test_sap_branch_takes_every_stream():
    """The sap branch's statics: no static pair list, no warm-start carry,
    hulls on the generic ground stream (the reference's), and an SDF
    collider's stream in the per-body stream."""
    sc = PS.mixed_pile(actors=40, broadphase="sap")
    w = sc.world
    mc = w.create_entity()
    w.create_component(mc, "mesh_collider", vertices=PS.box_mesh(*PS.SLAB),
                       triangles=PS.BOX_MESH_T, resolution=8)
    e = w.create_entity(position=(0.0, 3.0, 0.0))
    w.create_component(e, "rigid_actor", motion="dynamic", shape="convex",
                       points=PS.CUBE_CLOUD * 0.6)
    pm = w.modules["physics"]
    pm.invalidate_statics()
    st = pm.statics()
    assert st.sap and not st.banded and not st.has_conv_gnd and len(st.pair_a) == 0
    state = w.device_state("cpu")
    assert state.modules["physics"].sap_lam.numel() == 0
    step = sc.engine.build_step(w, "cpu")
    for _ in range(5):
        state = step(state, DT)
    c = pm._contact_stage(state, DT)
    v = st.poly_verts.shape[1]
    assert c.gc.depth.shape[-1] == (pm.ground_slots_per_body + v) * st.nb
    assert c.contacts.depth.shape[-1] == c.gc.depth.shape[-1] + 4 * pm.sap_neighbors * st.nb
    assert torch.isfinite(state.modules["physics"].pos).all()


# -- the banded branch over a batch ----------------------------------------------------


def _farm(api, actors=300):
    return PS.mixed_pile(api, actors=actors, broadphase="auto", neighbors=24)


def test_banded_batch_equals_each_world_alone():
    """W=3 diverging worlds through the batched banded branch, 30 frames
    from the batch's own state, each frame also taken by each world alone
    from the same state: within BATCH_ATOL, its ranks, carry and counters
    exactly."""
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    sc = _farm(None)
    pm = sc.world.modules["physics"]
    assert pm.statics().banded and pm.broadphase == "auto"
    step = sc.engine.build_step(sc.world, "cpu")
    batch = replicate_state(sc.world.device_state("cpu"), 3, torch.Generator().manual_seed(2))
    worst = 0.0
    for _ in range(30):
        tree = bridge.state_to_numpy(batch)
        batch = step(batch, DT)
        bm = batch.modules["physics"]
        for i in range(3):
            am = step(bridge.state_from_numpy({k: v[i] for k, v in tree.items()}, "cpu"),
                      DT).modules["physics"]
            for f in ("pos", "rot", "vel", "angvel", "sap_lam", "sap_glam"):
                err = float((getattr(bm, f)[i] - getattr(am, f)).abs().max())
                assert err <= BATCH_ATOL, (f, err)
                worst = max(worst, err)
            torch.testing.assert_close(bm.sap_rank[i], am.sap_rank, rtol=0, atol=0)
            for k, v in bm.counters.items():
                assert int(v[i]) == int(am.counters[k]), k
    assert int(bm.counters["active_contacts"].min()) > 50
    print("banded batch vs each world alone, max abs err", worst)


def test_banded_batch_matches_reference():
    """The same farm at W=3 against the JAX package's step under vmap, each
    of 8 frames from the reference's own state 12 frames into the drop (its
    bottom layer landing): bodies within STEP_POS_ATOL / STEP_VEL_ATOL,
    ranks and window certificates equal (the active-contact counts may part
    where a contact's depth sits at 0). A world that breaks them must hold
    them against the reference's eager step from the same state: its jitted
    step fuses multiply-adds and parts from its eager step at a few
    contact decisions."""
    from lumixengine_tpu.parallel.mesh import replicate_state as ref_replicate

    rsc, psc = _farm(jax_api()), _farm(None)
    rstep_one = rsc.engine.build_step(rsc.world, jit=False)
    rstep = jax.jit(jax.vmap(rstep_one, in_axes=(0, None)))
    rstate = ref_replicate(rsc.world.device_state(), 3, jax.random.PRNGKey(7))
    for _ in range(12):
        rstate = rstep(rstate, jnp.float32(DT))
    pstep = psc.engine.build_step(psc.world, "cpu")
    fields = (("pos", 0), ("rot", 0), ("vel", 1), ("angvel", 1), ("sap_lam", 1))
    worst, active, eager = [0.0, 0.0], [], []

    def world_gap(got, ref, w):
        err = [0.0, 0.0]
        for f, i in fields:
            err[i] = max(err[i], float(np.abs(got[PH + f][w] - ref[PH + f][w]).max()))
        same = all(np.array_equal(got[PH + f][w], ref[PH + f][w])
                   for f in ("sap_rank", "counters.sap_window_miss"))
        return err, same and err[0] <= STEP_POS_ATOL and err[1] <= STEP_VEL_ATOL

    for frame in range(8):
        tree = ref_to_numpy(rstate)
        pstate = pstep(bridge.state_from_numpy(tree, "cpu"), DT)
        rstate = rstep(rstate, jnp.float32(DT))
        got, ref = bridge.state_to_numpy(pstate), ref_to_numpy(rstate)
        for w in range(3):
            err, ok = world_gap(got, ref, w)
            if not ok:
                one = ref_from_numpy(rsc.world.device_state(), {k: v[w] for k, v in tree.items()})
                ref_w = {k: v[None] for k, v in ref_to_numpy(rstep_one(one, DT)).items()}
                got_w = {k: v[w][None] for k, v in got.items()}
                err, ok = world_gap(got_w, ref_w, 0)
                assert ok, (frame, w, err)
                eager.append((frame, w))
            worst = [max(a, b) for a, b in zip(worst, err)]
        active.append((got[PH + "counters.active_contacts"].tolist(),
                       ref[PH + "counters.active_contacts"].tolist()))
    assert min(min(a) for a, _r in active[-1:]) > 100, active
    print("banded batch vs reference max abs err (pos, vel)", worst, "held to the eager step",
          eager, "active (port, ref)", active)
