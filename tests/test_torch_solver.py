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


def test_plain_k2_on_small_scene():
    """The setup of the reference's own fused-solver parity test, at W=4 with
    per-world velocities and warm impulses."""
    from tests.test_physics import build_world

    engine, world, phys = build_world(actors=8)
    for i in range(4):
        e = world.create_entity(position=(i * 0.9, 1.0 + 0.4 * i, 0.0))
        world.create_component(e, "rigid_actor", motion="dynamic", shape=["box", "sphere"][i % 2],
                               half_extents=(0.5, 0.5, 0.5), radius=0.45)
    pm = world.modules["physics"]
    st = pm.statics()
    ms = world.device_state().modules["physics"]
    shape, radius, he = jnp.asarray(st.shape), jnp.asarray(st.radius), jnp.asarray(st.half_extents)
    gc = RP.ground_contacts(ms.pos, ms.rot, shape, radius, he, jnp.asarray(st.dyn_mask))
    pc = RP.pair_contacts(ms.pos, ms.rot, st.shape, radius, he, st.pair_a, st.pair_b)
    c = RP.concat_contacts(gc, pc)
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


@pytest.fixture(scope="module")
def settled_batch():
    """The slice world at frame 120, replicated to 4 diverging worlds by the
    reference, bridged into the port."""
    _e, _w, state = settled_reference()
    tree = ref_to_numpy(ref_replicate(state, 4, jax.random.PRNGKey(0)))
    _pe, pworld, _pr, _pp = port_world()
    return pworld, bridge.state_from_numpy(tree, "cpu")


def _piled(state):
    """The same worlds with the bodies moved into a tight pile (neighbours
    overlap by 5 cm), so that the compacted pair stream carries contacts."""
    pm = state.modules["physics"]
    nb = pm.pos.shape[-1]
    i = torch.arange(nb)
    grid = torch.stack([(i % 4) * 0.95, 0.45 + (i // 16) * 0.95, ((i // 4) % 4) * 0.95])
    pos = grid.to(pm.pos.dtype).expand(pm.pos.shape).clone()
    return state.replace(modules={**state.modules, "physics": pm.replace(pos=pos)})


@pytest.mark.parametrize("scene", ["settled", "piled"])
def test_plain_k2_on_pruned_contacts(settled_batch, scene):
    """Prologue + K2 on the contact set the pruned branch builds from the
    slice world at frame 120 (ground stream + compacted pair stream, gated
    warm impulses), against the reference prologue + Pallas kernel per world.
    At rest the bodies touch only the ground; the pile fills the pair stream."""
    pworld, state = settled_batch
    if scene == "piled":
        state = _piled(state)
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
    for s in (state, _piled(state)):
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
