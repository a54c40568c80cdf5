"""The port's jnp contact solve (``ops/physics_ops.py``: ``solve_contacts``,
``project_positions``, with ``select_points_onehot`` and
``gather_cols_onehot``) and the PhysicsModule's ``solver_backend`` against
the JAX package, on the CPU.

* The two functions on the operands of tests/test_physics_ext.py's fused
  parity test (4 bodies, boxes and spheres) and tests/test_physics_big.py's
  dynamic-solve test (5 boxes), with and without warm lambdas: within
  SOLVE_ATOL = 1e-5 (the per-body sums of the incidence products run in
  another order; observed about 1e-7).
* A PhysicsModule world for 30 frames on the all-pairs branch (the stack of
  three boxes) and on the pruned branch (the slice world, from its settled
  state): the port's "jnp" against the JAX module's "jnp", and the port's
  "auto" (kernel K2's plain version on the CPU) against the JAX module's
  fused Pallas solve in interpret mode; at the step harness's tolerances
  (BODY_POS_ATOL 1e-3, BODY_VEL_ATOL 5e-3, the counters exactly).
* "pallas" on a CPU device raises, as does an unknown backend.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu.ops import physics_ops as RP
from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.ops import physics_ops as PP
from test_torch_bridge import (DT, port_world, ref_from_numpy, ref_to_numpy, reference_step,
                               settled_reference, use_fused_solver)
from test_torch_physics_module import PH, build, compare_physics, scene_tree, stack3

torch.set_num_threads(1)

SOLVE_ATOL = 1e-5
FRAMES = 30


def T(a):
    return torch.from_numpy(np.array(a))


def _operands(scene: str):
    """The JAX tests' contact problem: (reference args, port args, statics)."""
    engine, world, _ = build("jax", actors=8)
    if scene == "physics_ext":       # tests/test_physics_ext.py:158-200
        for i in range(4):
            e = world.create_entity(position=(i * 0.9, 1.0 + 0.4 * i, 0.0))
            world.create_component(e, "rigid_actor", motion="dynamic", shape=["box", "sphere"][i % 2],
                                   half_extents=(0.5, 0.5, 0.5), radius=0.45)
        key, vs, ws = jax.random.PRNGKey(3), 0.5, 0.2
    else:                            # tests/test_physics_big.py:81
        for i in range(5):
            e = world.create_entity(position=(i * 0.9, 0.6 + 0.5 * i, 0.0))
            world.create_component(e, "rigid_actor", motion="dynamic", shape="box",
                                   half_extents=(0.5, 0.5, 0.5), friction=0.5)
        key, vs, ws = jax.random.PRNGKey(5), 0.4, 0.2
    st = world.modules["physics"].statics()
    ms = world.device_state().modules["physics"]
    vel = jax.random.normal(key, ms.vel.shape) * vs
    ang = jax.random.normal(jax.random.fold_in(key, 1), ms.angvel.shape) * ws
    shape, radius = jnp.asarray(st.shape), jnp.asarray(st.radius)
    he, dyn = jnp.asarray(st.half_extents), jnp.asarray(st.dyn_mask)
    gc = RP.ground_contacts(ms.pos, ms.rot, shape, radius, he, dyn)
    pc = RP.pair_contacts(ms.pos, ms.rot, st.shape, radius, he, st.pair_a, st.pair_b)
    c = RP.concat_contacts(gc, pc)
    iiw = RP.inv_inertia_world_diag(ms.rot, jnp.asarray(st.inv_inertia_body))
    ref = (ms.pos, ms.rot, vel, ang, c, st.inv_mass, iiw, st.incidence_a, st.incidence_b,
           1 / 60, st.friction, st.restitution)
    pc_ = PP.Contacts(*(T(np.asarray(x)) for x in c))
    port = (T(ms.pos), T(ms.rot), T(vel), T(ang), pc_, T(st.inv_mass), T(iiw),
            T(np.asarray(st.incidence_a, np.float32)), T(np.asarray(st.incidence_b, np.float32)),
            1 / 60, T(st.friction), T(st.restitution))
    return ref, port, c


def _close(got, ref, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=SOLVE_ATOL, err_msg=what)


@pytest.mark.parametrize("scene", ["physics_ext", "physics_big"])
@pytest.mark.parametrize("warm", [False, True])
def test_solve_and_projection_match_reference(scene, warm):
    ref, port, c = _operands(scene)
    active = np.asarray(c.active)
    assert active.sum() > 0
    kw = dict(iterations=8)
    if warm:
        rng = np.random.default_rng(11)
        lams = [rng.uniform(0, 0.3, active.shape).astype(np.float32),
                rng.normal(scale=0.05, size=active.shape).astype(np.float32),
                rng.normal(scale=0.05, size=active.shape).astype(np.float32)]
        lams[0][0] = -0.2                                 # clamped to 0 on the way in
        rv, rw, rl = RP.solve_contacts(*ref, **kw, warm_lambdas=tuple(map(jnp.asarray, lams)),
                                       return_lambdas=True)
        pv, pw, pl = PP.solve_contacts(*port, **kw, warm_lambdas=tuple(map(T, lams)),
                                       return_lambdas=True)
        for name, g, r in zip(("lam_n", "lam_t1", "lam_t2"), pl, rl):
            _close(g, r, name)
        assert float(np.abs(np.asarray(rl[0])).max()) > 0
    else:
        rv, rw = RP.solve_contacts(*ref, **kw)
        pv, pw = PP.solve_contacts(*port, **kw)
    _close(pv, rv, "vel")
    _close(pw, rw, "angvel")
    assert float(np.abs(np.asarray(rv) - np.asarray(ref[2])).max()) > 1e-3   # the solve acted
    for its in (1, 3):
        rp = RP.project_positions(ref[0], c, ref[5], ref[7], ref[8], iterations=its)
        pp = PP.project_positions(port[0], port[4], port[5], port[7], port[8], iterations=its)
        _close(pp, rp, f"project_positions x{its}")
    # the module's incidences from the contacts' body ids equal the statics'
    inc_a, inc_b = PP.incidences(port[4].body_a, port[4].body_b, port[0].shape[-1])
    np.testing.assert_array_equal(inc_a.numpy(), np.asarray(ref[7], np.float32))
    np.testing.assert_array_equal(inc_b.numpy(), np.asarray(ref[8], np.float32))


def test_where_masks_keep_inactive_nan_slots_out():
    """Inactive slots may carry NaN geometry. A NaN depth there stays out of
    the solve and the projection, as in the JAX package (both finite and
    equal); a NaN normal there stays out of the warm start's impulse."""
    ref, port, c = _operands("physics_big")
    inactive = ~np.asarray(c.active)
    assert inactive.any()
    depth = np.where(inactive, np.nan, np.asarray(c.depth)).astype(np.float32)
    rc = c._replace(depth=jnp.asarray(depth))
    pc = port[4]._replace(depth=T(depth))
    ref = ref[:4] + (rc,) + ref[5:]
    port = port[:4] + (pc,) + port[5:]
    warm = np.ones((3,) + depth.shape, np.float32)
    rv, rw = RP.solve_contacts(*ref, warm_lambdas=tuple(map(jnp.asarray, warm)))
    pv, pw = PP.solve_contacts(*port, warm_lambdas=tuple(map(T, warm)))
    assert torch.isfinite(pv).all() and torch.isfinite(pw).all()
    _close(pv, rv, "vel")
    _close(pw, rw, "angvel")
    rp = RP.project_positions(ref[0], rc, ref[5], ref[7], ref[8])
    pp = PP.project_positions(port[0], pc, port[5], port[7], port[8])
    assert torch.isfinite(pp).all()
    _close(pp, rp, "project_positions")
    nan_n = torch.where(T(inactive).unsqueeze(-2), float("nan"), pc.normal)
    v0, w0 = PP.solve_contacts(*port[:4], pc._replace(normal=nan_n), *port[5:], iterations=0,
                               warm_lambdas=tuple(map(T, warm)))
    assert torch.isfinite(v0).all() and torch.isfinite(w0).all()


def test_paused_step_is_finite():
    """At dt = 0 the Baumgarte bias is 0 (physics_ops.baumgarte_bias, as in
    K2's prologue), so a paused step on penetrating contacts stays finite;
    the JAX package's (baumgarte / dt) is inf or NaN there."""
    _ref, port, c = _operands("physics_big")
    assert np.asarray(c.depth)[np.asarray(c.active)].max() > 0.005
    for baumgarte in (0.2, 0.0):
        v, w = PP.solve_contacts(*port[:9], 0.0, *port[10:], baumgarte=baumgarte)
        assert torch.isfinite(v).all() and torch.isfinite(w).all()


# -- select_points_onehot, gather_cols_onehot ----------------------------------------------

@pytest.mark.parametrize("lead", [(), (3,)])
def test_onehot_gathers_equal_reference(lead):
    rng = np.random.default_rng(12)
    k, j, p, c, nb = 4, 8, 33, 3, 10
    pick = rng.integers(0, j, lead + (k, p))
    oh = (pick[..., None, :] == np.arange(j)[:, None]).astype(np.float32)   # [.., k, J, P]
    oh[..., 0, :, 0] = 0.0                                                 # a row selecting nothing
    pts = rng.normal(size=lead + (c, j, p)).astype(np.float32)
    np.testing.assert_array_equal(PP.select_points_onehot(T(oh), T(pts)).numpy(),
                                  np.asarray(RP.select_points_onehot(jnp.asarray(oh),
                                                                     jnp.asarray(pts))))
    idx = rng.integers(-1, nb + 2, lead + (p,)).astype(np.int32)           # some out of range
    for x in (rng.normal(size=lead + (nb,)).astype(np.float32),
              rng.normal(size=lead + (c, nb)).astype(np.float32),
              rng.integers(-50, 50, lead + (nb,)).astype(np.int32),
              rng.normal(size=(c, nb)).astype(np.float32)):               # shared by the batch
        got = PP.gather_cols_onehot(T(x), T(idx), nb)
        ref = RP.gather_cols_onehot(jnp.asarray(x), jnp.asarray(idx), nb)
        assert got.dtype == T(x).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- the PhysicsModule's solver_backend ----------------------------------------------------

def _run_module(rstep, rstate, pstep, pstate, frames):
    errs = {"active_contacts": 0}
    for f in range(frames):
        rstate = rstep(rstate, jnp.float32(DT))
        pstate = pstep(pstate, DT)
        got, ref = bridge.state_to_numpy(pstate), ref_to_numpy(rstate)
        compare_physics(got, ref, errs, where=f" (frame {f + 1})")
        errs["active_contacts"] = max(errs["active_contacts"],
                                      int(got[PH + "counters.active_contacts"].max()))
    return errs


@pytest.mark.parametrize("backend", ["jnp", "auto"])
def test_all_pairs_branch_backends_match_reference(backend, monkeypatch):
    rengine, rworld, pengine, pworld, tree = scene_tree(stack3)
    pm = pworld.modules["physics"]
    assert not pm.statics().pruned and not pm.statics().sap
    if backend == "jnp":
        monkeypatch.setattr(rworld.modules["physics"], "solver_backend", "jnp")
    else:
        use_fused_solver(monkeypatch, rworld)
    pm.solver_backend = backend
    rstep = jax.jit(rengine.build_step(rworld, jit=False))
    errs = _run_module(rstep, ref_from_numpy(rworld.device_state(), tree),
                       pengine.build_step(pworld, "cpu"), bridge.state_from_numpy(tree, "cpu"),
                       FRAMES)
    print(f"all-pairs {backend}: max abs err", {k: f"{v:.2e}" for k, v in errs.items() if v})
    assert errs["active_contacts"] > 0


@pytest.mark.parametrize("backend", ["jnp", "auto"])
def test_pruned_branch_backends_match_reference(backend, monkeypatch):
    """The slice world (the pruned branch, its warm-start gate by pair
    identity) from its settled state, with the cull pass, 30 frames."""
    engine, rworld, rstate = settled_reference()
    if backend == "jnp":
        monkeypatch.setattr(rworld.modules["physics"], "solver_backend", "jnp")
    else:
        use_fused_solver(monkeypatch, rworld)
    rstep = reference_step(engine, rworld, batched=False)
    pengine, pworld, _pr, _pp = port_world()
    pm = pworld.modules["physics"]
    assert pm.statics().pruned
    pm.solver_backend = backend
    pstep = pengine.build_step(pworld, "cpu", extra=pworld.modules["renderer"].cull_pass)
    errs = _run_module(rstep, rstate, pstep, bridge.state_from_numpy(ref_to_numpy(rstate), "cpu"),
                       FRAMES)
    print(f"pruned {backend}: max abs err", {k: f"{v:.2e}" for k, v in errs.items() if v})
    assert errs["active_contacts"] > 0


def test_backend_choice_is_checked():
    from lumixengine_tpu_torch.physics.module import PhysicsModule

    _e, world, _ = stack3("torch")
    pm = world.modules["physics"]
    assert pm.solver_backend == "auto"
    with pytest.raises(ValueError, match="solver_backend"):
        PhysicsModule(world, pm.system, solver_backend="fused")
    pm.solver_backend = "pallas"
    step = _e.build_step(world, "cpu")
    with pytest.raises(ValueError, match="cpu"):
        step(world.device_state("cpu"), DT)
