"""The fused contact solve (prologue + kernel K2's plain version) against the
reference's solve_contacts_fused in Pallas interpret mode, and the pruned
branch's pair compaction against the reference's compact_pairs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu.ops import physics_big as rbig
from lumixengine_tpu.ops import physics_ops as RP
from lumixengine_tpu.ops.solver_pallas import solve_contacts_fused as ref_fused
from lumixengine_tpu.parallel.mesh import replicate_state as ref_replicate
from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.models.demo_scenes import pile_bodies
from lumixengine_tpu_torch.ops import physics_big as big
from lumixengine_tpu_torch.ops import physics_ops as P
from lumixengine_tpu_torch.ops import solver as S
from test_torch_bridge import DT, port_world, ref_to_numpy, settled_reference

torch.set_num_threads(1)

# the JAX package's own fused-vs-jnp bound (tests/test_physics_ext.py): the
# solvers sum the same impulses in another order
ATOL = 5e-3
ITERATIONS, POSITION_ITERATIONS = 10, 3


def _incidence(body, nb):
    """Reference one-hot incidence [NB, C] from a body column (-1 = none)."""
    body = np.asarray(body)
    inc = np.zeros((nb, body.shape[-1]), np.float32)
    ok = body >= 0
    inc[body[ok], np.nonzero(ok)[0]] = 1.0
    return inc


def _port_contacts(c):
    return P.Contacts(body_a=torch.as_tensor(np.asarray(c["body_a"]), dtype=torch.int64),
                      body_b=torch.as_tensor(np.asarray(c["body_b"]), dtype=torch.int64),
                      point=torch.tensor(np.asarray(c["point"])),
                      normal=torch.tensor(np.asarray(c["normal"])),
                      depth=torch.tensor(np.asarray(c["depth"])),
                      active=torch.tensor(np.asarray(c["active"])))


def _compare(port_out, ref_out):
    names = ("vel", "angvel", "lam_n", "lam_t1", "lam_t2", "dpos")
    errs = {}
    for name, got, ref in zip(names, port_out, ref_out):
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.shape == ref.shape, name
        errs[name] = float(np.abs(got - ref).max())
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL, err_msg=name)
    print("max abs err", errs)
    return errs


def _small_scene():
    """The reference's fused-solver parity scene: 8 actor slots, 4 bodies
    above the ground; its contacts, mass properties and materials."""
    from tests.test_physics import build_world

    _engine, world, _phys = build_world(actors=8)
    for i in range(4):
        e = world.create_entity(position=(i * 0.9, 1.0 + 0.4 * i, 0.0))
        world.create_component(e, "rigid_actor", motion="dynamic", shape=["box", "sphere"][i % 2],
                               half_extents=(0.5, 0.5, 0.5), radius=0.45)
    st = world.modules["physics"].statics()
    ms = world.device_state().modules["physics"]
    shape, radius, he = jnp.asarray(st.shape), jnp.asarray(st.radius), jnp.asarray(st.half_extents)
    gc = RP.ground_contacts(ms.pos, ms.rot, shape, radius, he, jnp.asarray(st.dyn_mask))
    pc = RP.pair_contacts(ms.pos, ms.rot, st.shape, radius, he, st.pair_a, st.pair_b)
    return st, ms, RP.concat_contacts(gc, pc)


def test_plain_k2_on_small_scene():
    """The setup of the reference's own fused-solver parity test, at W=4 with
    per-world velocities and warm impulses."""
    st, ms, c = _small_scene()
    iiw = RP.inv_inertia_world_diag(ms.rot, jnp.asarray(st.inv_inertia_body))
    w, nb, nc = 4, ms.pos.shape[-1], c.depth.shape[-1]
    rng = np.random.default_rng(3)
    vel = rng.normal(0, 0.5, (w, 3, nb)).astype(np.float32)
    ang = rng.normal(0, 0.2, (w, 3, nb)).astype(np.float32)
    warm = (rng.uniform(0, 0.2, (w, nc)).astype(np.float32),
            rng.normal(0, 0.05, (w, nc)).astype(np.float32),
            rng.normal(0, 0.05, (w, nc)).astype(np.float32))
    pos = np.broadcast_to(np.asarray(ms.pos), (w, 3, nb)).copy()
    assert int(np.asarray(c.active).sum()) > 0

    rv, rw, rl, rd = ref_fused(
        jnp.asarray(pos), ms.rot, jnp.asarray(vel), jnp.asarray(ang), c, st.inv_mass, iiw,
        st.incidence_a, st.incidence_b, DT, st.friction, st.restitution,
        iterations=ITERATIONS, baumgarte=0.0, warm_lambdas=tuple(map(jnp.asarray, warm)),
        return_lambdas=True, position_iterations=POSITION_ITERATIONS, return_dpos=True,
        interpret=True)
    pv, pw_, pl, pd = S.solve_contacts_fused(
        torch.tensor(pos), torch.tensor(vel), torch.tensor(ang),
        _port_contacts(c._asdict()), torch.tensor(st.inv_mass), torch.tensor(np.asarray(iiw)),
        torch.tensor(DT), torch.tensor(st.friction), torch.tensor(st.restitution),
        iterations=ITERATIONS, position_iterations=POSITION_ITERATIONS, baumgarte=0.0,
        warm_lambdas=tuple(map(torch.tensor, warm)))
    _compare((pv, pw_, *pl, pd), (rv, rw, *rl, rd))


def test_inactive_slots_are_inert():
    """Contacts with `active` False but random finite points, normals and
    depths (and random warm lambdas) give zero lambdas, and the same bodies
    as the same contacts zeroed, in the plain version and in the reference's
    fused kernel: K2 may skip them after writing their lambdas."""
    st, ms, c = _small_scene()
    w, nb, nc = 4, ms.pos.shape[-1], c.depth.shape[-1]
    off = ~np.asarray(c.active)
    assert off.sum() > 0 and (~off).sum() > 0
    rng = np.random.default_rng(5)
    vel = rng.normal(0, 0.5, (w, 3, nb)).astype(np.float32)
    ang = rng.normal(0, 0.2, (w, 3, nb)).astype(np.float32)
    warm = (rng.uniform(0, 0.2, (w, nc)).astype(np.float32),
            rng.normal(0, 0.05, (w, nc)).astype(np.float32),
            rng.normal(0, 0.05, (w, nc)).astype(np.float32))
    pos = np.broadcast_to(np.asarray(ms.pos), (w, 3, nb)).copy()
    iiw = RP.inv_inertia_world_diag(ms.rot, jnp.asarray(st.inv_inertia_body))
    noise = {"point": rng.uniform(-3.0, 3.0, (3, nc)), "normal": rng.normal(size=(3, nc)),
             "depth": rng.uniform(-0.1, 0.2, nc)}
    variants = {}
    for name in ("random", "zeroed"):
        fields = c._asdict()
        for k, x in noise.items():
            fields[k] = np.where(off, x if name == "random" else 0.0,
                                 np.asarray(fields[k])).astype(np.float32)
        variants[name] = RP.Contacts(**fields)
    outs = {}
    for name, cv in variants.items():
        rv, rw, rl, rd = ref_fused(
            jnp.asarray(pos), ms.rot, jnp.asarray(vel), jnp.asarray(ang), cv, st.inv_mass, iiw,
            st.incidence_a, st.incidence_b, DT, st.friction, st.restitution,
            iterations=ITERATIONS, baumgarte=0.0, warm_lambdas=tuple(map(jnp.asarray, warm)),
            return_lambdas=True, position_iterations=POSITION_ITERATIONS, return_dpos=True,
            interpret=True)
        pv, pw_, pl, pd = S.solve_contacts_fused(
            torch.tensor(pos), torch.tensor(vel), torch.tensor(ang),
            _port_contacts(cv._asdict()), torch.tensor(st.inv_mass),
            torch.tensor(np.asarray(iiw)), torch.tensor(DT), torch.tensor(st.friction),
            torch.tensor(st.restitution), iterations=ITERATIONS,
            position_iterations=POSITION_ITERATIONS, baumgarte=0.0,
            warm_lambdas=tuple(map(torch.tensor, warm)))
        outs[name] = {"reference": [np.asarray(x) for x in (rv, rw, *rl, rd)],
                      "port": [x.numpy() for x in (pv, pw_, *pl, pd)]}
    names = ("vel", "angvel", "lam_n", "lam_t1", "lam_t2", "dpos")
    for impl in ("reference", "port"):
        for name, got, ref in zip(names, outs["random"][impl], outs["zeroed"][impl]):
            if name.startswith("lam"):
                assert not np.any(got[..., off]), (impl, name)
            np.testing.assert_array_equal(got, ref, err_msg=f"{impl} {name}")


K2_MAIN_BYTES = 246_939_904   # W=1024, NB=64, C=1792 all active: 246.9 MB, 73.7 us at 3.35 TB/s
K2_SETTLED_ACTIVE = 154_947   # the settled flagship problem's active slots (chip_smoke phase 4)
K2_SETTLED_BYTES = 72_213_560  # its bytes: 72.2 MB, 21.6 us at 3.35 TB/s
K1_MAIN_BYTES = 178_388_992   # [1024, 3, 10240]: 178.3 MB of spheres + 0.13 MB of planes


def test_kernel_byte_counts():
    """The bytes chip_smoke.py holds the kernels' times against: every
    operand the function needs read once, every output written once, at the
    main path's shapes; K2's inactive slots need act, the warm-start and the
    output lambdas only."""
    from lumixengine_tpu_torch.ops import culling

    w, nb, c = 1024, 64, 1792
    assert S.k2_bytes(w, nb, c, w * c) == K2_MAIN_BYTES
    assert S.k2_bytes(w, nb, c, w * c) == w * c * (30 + 3) * 4 + w * 18 * nb * 4 + nb * 4
    assert round(K2_MAIN_BYTES / 3.35e12 * 1e6, 1) == 73.7
    settled = S.k2_bytes(w, nb, c, K2_SETTLED_ACTIVE)
    assert settled == K2_SETTLED_BYTES
    assert settled == (K2_SETTLED_ACTIVE * 132 + (w * c - K2_SETTLED_ACTIVE) * 28
                       + w * 18 * nb * 4 + nb * 4)
    assert round(settled / 3.35e12 * 1e6, 1) == 21.6
    assert S.k2_bytes(w, nb, c, 0) < settled < K2_MAIN_BYTES
    assert culling.k1_bytes(1024, 10240) == K1_MAIN_BYTES
    assert round(K1_MAIN_BYTES / 3.35e12 * 1e6, 1) == 53.3
    # the active-contact work: under a seventh of the bytes' time at the card's fp32 rate
    flops = S.k2_flops(w, nb, c, K2_SETTLED_ACTIVE, 535, ITERATIONS, POSITION_ITERATIONS)
    assert flops / 67e12 < settled / 3.35e12 / 7


def test_k2_plan_takes_every_pruned_shape():
    """Every (NB, C) the pruned branch makes up to NB = 256 actors
    (C = 4 NB + 4 min(max(128, 6 NB_dyn), pairs), more than 192 pairs) has a
    plan within the card's limits; beyond the stated limit, or for C not a
    multiple of 4, k2_plan raises."""
    n = 0
    for nb in range(1, 257):
        pairs = nb * (nb - 1) // 2
        if pairs <= 192:
            continue
        for budget in range(128, min(max(128, 6 * nb), pairs) + 1):
            c = 4 * nb + 4 * budget
            plan = S.k2_plan(nb, c)
            assert plan.cluster * plan.share >= c and plan.smem <= S.K2_SMEM_MAX
            assert plan.share % 4 == 0 and plan.threads % 32 == 0
            for cap, smem, per_sm in zip(plan.caps, plan.cap_smems, S.K2_TIERS):
                assert cap == 0 or smem <= S.K2_SMEM_SM // per_sm - 1_024
            n += 1
    assert n > 100_000
    assert S.k2_plan(64, 1792).cluster == 1 and min(S.k2_plan(64, 1792).caps) > 0
    assert S.k2_plan(256, 7168).cluster == 8
    limit = S.k2_max_c(256)
    assert limit >= 7168 and S.k2_plan(256, limit).cluster == 8
    for bad in ((256, limit + 4), (64, 1798), (0, 1792)):
        with pytest.raises(ValueError, match="K2"):
            S.k2_plan(*bad)


def test_module_shape_is_planned(settled_batch):
    pworld, _state = settled_batch
    st = pworld.modules["physics"].statics()
    plan = S.k2_plan(st.nb, st.n_contact_slots)
    assert plan.cluster == 1 and plan.share == st.n_contact_slots


@pytest.fixture(scope="module")
def settled_batch():
    """The slice world at frame 120, replicated to 4 diverging worlds by the
    reference, bridged into the port."""
    _e, _w, state = settled_reference()
    tree = ref_to_numpy(ref_replicate(state, 4, jax.random.PRNGKey(0)))
    _pe, pworld, _pr, _pp = port_world()
    return pworld, bridge.state_from_numpy(tree, "cpu")


@pytest.mark.parametrize("scene", ["settled", "piled"])
def test_plain_k2_on_pruned_contacts(settled_batch, scene):
    """Prologue + K2 on the contact set the pruned branch builds from the
    slice world at frame 120 (ground stream + compacted pair stream, gated
    warm impulses), against the reference prologue + Pallas kernel per world.
    At rest the bodies touch only the ground; the pile fills the pair stream."""
    pworld, state = settled_batch
    if scene == "piled":
        state = pile_bodies(state)
    pm = pworld.modules["physics"]
    c = pm._contact_stage(state, DT)
    k = pm.points_per_pair
    pair_active = int(c.contacts.active[:, -k * pm.statics().pair_budget:].sum())
    print(f"{scene}: active contacts {int(c.contacts.active.sum())}, in the pair stream {pair_active}")
    assert int(c.contacts.active.sum()) > 0 and (pair_active > 0) == (scene == "piled")
    assert float(torch.stack(c.warm).abs().max()) > 0.0
    nb = state.modules["physics"].pos.shape[-1]

    def ref_world(i):
        inc_a = _incidence(c.contacts.body_a[i].numpy(), nb)
        inc_b = _incidence(c.contacts.body_b[i].numpy(), nb)
        contacts = RP.Contacts(body_a=None, body_b=None,
                               point=jnp.asarray(c.contacts.point[i].numpy()),
                               normal=jnp.asarray(c.contacts.normal[i].numpy()),
                               depth=jnp.asarray(c.contacts.depth[i].numpy()),
                               active=jnp.asarray(c.contacts.active[i].numpy()))
        return ref_fused(
            jnp.asarray(c.pos[i].numpy()), jnp.asarray(c.rot[i].numpy()),
            jnp.asarray(c.vel[i].numpy()), jnp.asarray(c.angvel[i].numpy()), contacts,
            np.asarray(c.d.inv_mass), jnp.asarray(c.iiw[i].numpy()), inc_a, inc_b,
            jnp.float32(c.dt_c), jnp.asarray(c.fric[i].numpy()), jnp.asarray(c.rest[i].numpy()),
            iterations=ITERATIONS, baumgarte=0.0,
            warm_lambdas=tuple(jnp.asarray(x[i].numpy()) for x in c.warm),
            return_lambdas=True, position_iterations=POSITION_ITERATIONS, return_dpos=True,
            interpret=True)

    refs = [ref_world(i) for i in range(state.local.pos.shape[0])]
    ref = [np.stack([np.asarray(r[0]) for r in refs]), np.stack([np.asarray(r[1]) for r in refs])]
    ref += [np.stack([np.asarray(r[2][j]) for r in refs]) for j in range(3)]
    ref += [np.stack([np.asarray(r[3]) for r in refs])]
    pv, pw_, pl, pd = S.solve_contacts_fused(
        c.pos, c.vel, c.angvel, c.contacts, c.d.inv_mass, c.iiw, c.dt_c, c.fric, c.rest,
        iterations=ITERATIONS, position_iterations=POSITION_ITERATIONS, baumgarte=0.0,
        warm_lambdas=c.warm)
    _compare((pv, pw_, *pl, pd), ref)


@pytest.mark.parametrize("fault", ["one iteration short", "one projection pass short"])
def test_k2_limit_catches_planted_faults(settled_batch, fault):
    """K2 is held to its plain version at K2_PLAIN_ATOL (on the card). The
    plain version run one iteration or one projection pass short must miss
    that limit on the slice's contacts, so a kernel with such a fault fails."""
    pworld, state = settled_batch
    pm = pworld.modules["physics"]
    its = {"one iteration short": (ITERATIONS - 1, POSITION_ITERATIONS),
           "one projection pass short": (ITERATIONS, POSITION_ITERATIONS - 1)}[fault]
    errs = []
    for s in (state, pile_bodies(state)):
        prob = pm.solver_problem(s, DT)
        ref = S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS)
        errs.append(max(float((a - b).abs().max()) for a, b in zip(S.solve_plain(prob, *its), ref)))
    print(fault, "max abs err vs plain (settled, piled)", errs)
    assert max(errs) > S.K2_PLAIN_ATOL


def test_solver_problem_is_what_the_step_solves(settled_batch):
    pworld, state = settled_batch
    pm = pworld.modules["physics"]
    prob = pm.solver_problem(state, DT)
    assert prob.body_a.dtype == torch.int32 and prob.body_a.shape == prob.act.shape
    assert prob.act.shape == (4, pm.statics().n_contact_slots)
    v, w, dpos, ln, lt1, lt2 = S.solve(prob, ITERATIONS, POSITION_ITERATIONS)
    c = pm._contact_stage(state, DT)
    fv, fw, (fl, _t1, _t2), fd = S.solve_contacts_fused(
        c.pos, c.vel, c.angvel, c.contacts, c.d.inv_mass, c.iiw, c.dt_c, c.fric, c.rest,
        iterations=ITERATIONS, position_iterations=POSITION_ITERATIONS, baumgarte=0.0,
        warm_lambdas=c.warm)
    for a, b in ((v, fv), (w, fw), (ln, fl), (dpos, fd)):
        assert torch.equal(a, b)


def test_solve_dispatch():
    prob = S.ContactProblem(**{f: torch.zeros((1, 4), device="meta")
                               for f in S.ContactProblem.__dataclass_fields__})
    before = S.solve_cuda.launches
    with pytest.raises(ValueError, match="unsupported device"):
        S.solve(prob, 1, 1)
    assert S.solve_cuda.launches == before


@pytest.mark.parametrize("density,budget", [(0.02, 192), (0.3, 192), (0.6, 64), (0.0, 32),
                                            (1.0, 496), (0.5, 8)])
def test_compact_pairs_matches_reference(density, budget):
    rng = np.random.default_rng(int(density * 100) + budget)
    pa, pb = np.triu_indices(32, k=1)
    pa, pb = pa.astype(np.int32), pb.astype(np.int32)
    ok = rng.random((5, pa.size)) < density
    got = big.compact_pairs(torch.as_tensor(pa, dtype=torch.int64),
                            torch.as_tensor(pb, dtype=torch.int64), torch.tensor(ok), budget)
    for w in range(ok.shape[0]):
        ref = rbig.compact_pairs(pa, pb, jnp.asarray(ok[w]), budget)
        for name, g, r in zip(("pa_c", "pb_c", "valid", "overflow"), got, ref):
            np.testing.assert_array_equal(g[w].numpy(), np.asarray(r), err_msg=name)
    assert int(got[3].max()) == max(int(ok.sum(1).max()) - budget, 0)


def test_compact_pairs_single_world_overflow():
    pa = np.arange(10, dtype=np.int32)
    pb = pa + 1
    ok = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 1], bool)
    got = big.compact_pairs(torch.as_tensor(pa, dtype=torch.int64),
                            torch.as_tensor(pb, dtype=torch.int64), torch.tensor(ok), 4)
    ref = rbig.compact_pairs(pa, pb, jnp.asarray(ok), 4)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0].tolist() == [0, 2, 3, 5] and int(got[3]) == 3
