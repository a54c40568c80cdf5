"""The game-content PhysicsModule against the JAX package's: the props
world (on the all-pairs branch, and forced onto the pruned one), the drive
and terrain worlds and a small banded props level
(lumixengine_tpu_torch/models/physics_scenes.py), each built by both
packages from the same builder (the JAX package's classes passed in), run
side by side on a batch of worlds that diverge, field by field through the
bridge, the controllers' ctrl_* and the vehicles' veh_* included; the drive
world's raycasts and sweeps every frame; then each world's own physical
checks (the JAX tests' bounds) on the port alone.

Tolerances: pos and rot within BODY_POS_ATOL, velocities and
impulses within BODY_VEL_ATOL, counters, sleep, grounded flags, ranks and
the vehicle inputs equal. Where a frame breaks them, the port's same frame
from the reference's own state must hold them (the port computes the frame
right) and the break is a decision the trajectories' sub-tolerance drift
flipped; or else, from the same state, the two contact sets may differ
only at ties (a contact at the active threshold, or another vertex or axis
of the same depth picked by a top-k or an argmin: a hull resting face down
on an equal face ties in exact arithmetic, and rounding picks, in the JAX
package's own jitted and eager steps too) or, with no tie, by at most
CONTACT_TIE_ATOL, and with the reference's contact set the port's frame
holds the tolerances (physics_scenes.explain_break). Each flip is printed
with its margin, and both go on from the reference's state. The JAX module
runs its fused Pallas contact solve in interpret mode, the semantics kernel
K2 ports."""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.models import physics_scenes as PS
from test_torch_bridge import DT, ref_from_numpy, ref_to_numpy, use_fused_solver

torch.set_num_threads(1)

BODY_POS_ATOL = 1e-5     # pos, rot, transforms, controller positions
BODY_VEL_ATOL = 1e-4     # vel, angvel, warm-start impulses
# ray and sweep distances: the sphere test's b² − c cancels at |b| ≈ t, so an
# ulp of b² (1.2e-7·t²; the reference's fused multiply-adds round it
# otherwise) moves t by up to that over 2·sqrt(b² − c)
QUERY_T_ATOL, QUERY_T_RTOL = 1e-5, 1e-5
PH = PS.PH

def jax_api():
    from lumixengine_tpu.engine.engine import Engine
    from lumixengine_tpu.physics.module import PhysicsSystem
    from lumixengine_tpu.renderer.model import Model
    from lumixengine_tpu.renderer.render_module import RendererSystem

    return SimpleNamespace(Engine=Engine, PhysicsSystem=PhysicsSystem,
                           RendererSystem=RendererSystem, Model=Model)


def small_banded(api=None, hulls=16, stack=1, neighbors=7):
    """A banded props level at test size, the banded branch forced (the JAX
    package's banded tests force it too) with the window of its convex
    tests, 7: by default 16 hulls over the slab in one layer, meeting the
    slab and not each other."""
    sc = PS.banded_props_level(api, hulls=hulls, capacity=hulls + 4, neighbors=neighbors,
                               stack=stack)
    pm = sc.world.modules["physics"]
    pm.broadphase = "banded"
    pm.invalidate_statics()
    return sc


def stacked_banded(api=None, neighbors=7):
    """The banded props level scaled down to 4 of its stacks of 5 hulls,
    all on the slab: hulls resting on hulls."""
    return small_banded(api, hulls=20, stack=5, neighbors=neighbors)


def pruned_props(api=None):
    """The props world on the pruned branch (forced: its 165 simple pairs
    are below the threshold): the simple pairs compacted into the budget
    and appended after the static [ground | hull pairs | hull ground | SDF]
    slots."""
    sc = PS.props_world(api)
    pm = sc.world.modules["physics"]
    pm.broadphase = "pruned"
    pm.invalidate_statics()
    return sc


SCENES = {  # kind: (builder, worlds, frames)
    "props": (PS.props_world, 2, 45),
    "props_pruned": (pruned_props, 2, 30),
    "drive": (PS.drive_world, 3, 60),
    "terrain": (PS.terrain_world, 2, 60),
    "banded": (small_banded, 2, 40),
    "banded_stacked": (stacked_banded, 2, 60),
}


def gap(got, ref):
    """(largest abs difference of each field, first break or None) at the
    tolerances, sleep counters equal."""
    return PS.state_gap(got, ref, BODY_POS_ATOL, BODY_VEL_ATOL)[:2]


def ref_inputs(kind, sc, state, frame):
    """scene_inputs on the reference's state (the same host calls)."""
    pm = sc.world.modules["physics"]
    if kind == "drive":
        if frame in (0, 30, 120):
            state = pm.set_vehicle_input(state, sc.ents["car"], *PS.drive_inputs(frame))
        state = pm.move_controller(state, sc.ents["player"], jnp.asarray(PS.PLAYER_STEP))
    elif kind == "terrain":
        state = pm.move_controller(state, sc.ents["walker"], jnp.asarray(PS.WALKER_STEP))
    return state


def ref_queries(sc, state, offsets, dirs):
    """The drive world's queries through the JAX module, each world and ray
    under vmap."""
    pm = sc.world.modules["physics"]
    slot = sc.slots["car"]

    def one(ms):
        origin = ms.pos[:, slot][None, :] + offsets

        def ray(o, d):
            return (pm.raycast(ms, o, d, layer_mask=PS.DRIVE_LAYER_MASK),
                    pm.sweep(ms, o, d, PS.DRIVE_SWEEP_RADIUS, layer_mask=PS.DRIVE_LAYER_MASK))

        return jax.vmap(ray)(origin, dirs)

    return jax.vmap(one)(state.modules["physics"])


def compare_queries(got, ref, frame):
    for (hg, tg, ig), (hr, tr, ir) in zip(got, ref):
        hr, tr, ir = np.asarray(hr), np.asarray(tr), np.asarray(ir)
        np.testing.assert_array_equal(hg.numpy(), hr, err_msg=f"hit flags, frame {frame}")
        np.testing.assert_array_equal(np.where(hr, ig.numpy(), 0), np.where(hr, ir, 0),
                                      err_msg=f"hit bodies, frame {frame}")
        np.testing.assert_allclose(tg.numpy()[hr], tr[hr], rtol=QUERY_T_RTOL, atol=QUERY_T_ATOL,
                                   err_msg=f"hit distances, frame {frame}")
    return int(np.asarray(ref[0][0]).sum())


@functools.lru_cache(maxsize=None)
def built(kind):
    """Both packages' builds of scene `kind` and the start state as numpy:
    the reference's device state with the start velocities, tiled to the
    scene's worlds with the reference's replicate_state (diverging)."""
    from lumixengine_tpu.parallel.mesh import replicate_state as ref_replicate

    builder, worlds, _frames = SCENES[kind]
    rsc, psc = builder(jax_api()), builder()
    single = ref_to_numpy(rsc.world.device_state())
    own = bridge.state_to_numpy(psc.world.device_state("cpu"))
    assert set(own) == set(single)
    for k, v in own.items():
        assert (v.dtype, v.shape) == (single[k].dtype, single[k].shape), k
        np.testing.assert_allclose(v, single[k], rtol=0, atol=1e-6, err_msg=k)
    vel = single[PH + "vel"].copy()
    for slot, v in rsc.velocities.items():
        vel[:, slot] = v
    single[PH + "vel"] = vel
    template = rsc.world.device_state()
    tree = ref_to_numpy(ref_replicate(ref_from_numpy(template, single), worlds,
                                      jax.random.PRNGKey(4)))
    return rsc, psc, tree


def ref_step_with_contacts(rsc, worlds):
    """The reference's step, jitted under vmap, returning its contact set
    (point, normal, depth, active) beside the state: the operands its fused
    solve gets."""
    import lumixengine_tpu.ops.solver_pallas as SP

    step = rsc.engine.build_step(rsc.world, jit=False)

    def one(state, dt):
        cap, real = {}, SP.solve_contacts_fused

        def record(*args, **kw):
            cap["c"] = args[4]
            return real(*args, **kw)

        SP.solve_contacts_fused = record
        try:
            out = step(state, dt)
        finally:
            SP.solve_contacts_fused = real
        c = cap["c"]
        return out, (c.point, c.normal, c.depth, c.active)

    return jax.jit(jax.vmap(one, in_axes=(0, None)))


@functools.lru_cache(maxsize=None)
def _ref_banded_sat(batched: bool):
    import lumixengine_tpu.ops.physics_banded as RPBD

    fn = RPBD.banded_polytope_grids
    if batched:   # the port sorts every world of a batch at once; the reference under vmap
        fn = jax.vmap(fn, in_axes=(0, 0, 0, 0, 0, None, None))
    return jax.jit(fn, static_argnums=(5, 6))


def ref_banded_sat(*args):
    """The reference's banded polytope SAT, jitted as in its step, on the
    port's inputs (torch on the CPU; the window and points per pair last;
    a leading world axis taken world by world)."""
    out = _ref_banded_sat(args[0].dim() == 3)(*(jnp.asarray(x.numpy()) for x in args[:5]),
                                              *args[5:])
    return tuple(torch.as_tensor(np.array(x)) for x in out)


def run_side_by_side(kind, monkeypatch):
    """The scene's frames in both packages, compared after each; returns
    (flips [(frame, cause, margin)], largest gaps, ray hits, the most active
    contacts of a world and frame, last states)."""
    rsc, psc, tree = built(kind)
    _b, worlds, frames = SCENES[kind]
    use_fused_solver(monkeypatch, rsc.world)
    rstep = jax.jit(jax.vmap(rsc.engine.build_step(rsc.world, jit=False), in_axes=(0, None)))
    rstep_c = None
    pm = psc.world.modules["physics"]
    pstep = psc.engine.build_step(psc.world, "cpu")
    rstate = ref_from_numpy(jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (worlds,) + x.shape), rsc.world.device_state()), tree)
    pstate = bridge.state_from_numpy(tree, "cpu")
    offs, dirs = PS.drive_rays()
    toffs, tdirs = torch.as_tensor(offs), torch.as_tensor(dirs)
    flips, worst, hits, active = [], {}, 0, 0
    for f in range(frames):
        rstate = ref_inputs(kind, rsc, rstate, f)
        pstate = PS.scene_inputs(kind, psc, pstate, f)
        before = ref_to_numpy(rstate)
        rnext = rstep(rstate, jnp.float32(DT))
        pnext = pstep(pstate, DT)
        got, ref = bridge.state_to_numpy(pnext), ref_to_numpy(rnext)
        errs, broke = gap(got, ref)
        if broke is not None:
            # explained as a decision the runs' drift flipped, or one at a
            # tie (or rounding) of the contact sets from the same state
            drift = max(gap(bridge.state_to_numpy(pstate), before)[0].values())
            start = bridge.state_from_numpy(before, "cpu")

            def ref_contacts():
                nonlocal rstep_c
                rstep_c = rstep_c or ref_step_with_contacts(rsc, worlds)
                return rstep_c(rstate, jnp.float32(DT))[1]

            banded = kind.startswith("banded")
            cause, margin, errs = PS.explain_break(
                pstep, start, ref, gap, drift, pm, None if banded else ref_contacts,
                ref_banded_sat if banded else None)
            flips.append((f + 1, cause, margin))
            pnext = bridge.state_from_numpy(ref, "cpu")   # both go on from the reference's
            got = ref
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0.0), v)
        active = max(active, int(got[PH + "counters.active_contacts"].max()))
        rstate, pstate = rnext, pnext
        if kind == "drive":
            hits += compare_queries(PS.drive_queries(psc, pnext, toffs, tdirs),
                                    ref_queries(rsc, rstate, jnp.asarray(offs), jnp.asarray(dirs)),
                                    f + 1)
    return flips, worst, hits, active, got, ref


@pytest.mark.parametrize("kind", list(SCENES))
def test_scene_matches_reference_frame_by_frame(kind, monkeypatch):
    flips, worst, hits, active, got, ref = run_side_by_side(kind, monkeypatch)
    shown = {k.replace(PH, ""): f"{v:.2e}" for k, v in worst.items() if v}
    print(f"{kind}: {SCENES[kind][2]} frames at W={SCENES[kind][1]}, max abs err {shown}; "
          f"decisions flipped (frame, cause, margin): {flips}; ray hits {hits}")
    assert active > 0
    if kind == "drive":
        assert hits > 0
        assert got[PH + "veh_throttle"].max() == 1.0 and got[PH + "ctrl_grounded"].any()
    if kind == "terrain":
        assert got[PH + "ctrl_grounded"][:, 0].all()
    if kind == "banded":
        assert got[PH + "sap_glam"].shape[-2] == 4 + 16 + 16   # ground + hull ground + SDF
        assert (got[PH + "counters.sap_window_miss"] == ref[PH + "counters.sap_window_miss"]).all()


def test_scenes_exercise_what_they_name():
    """Each world reaches its features: hulls, SDF colliders, CCD bodies and
    instanced statics in the props world (all-pairs branch); the vehicle,
    its 4 wheels and the controller in the drive world; the heightfield in
    place of the plane in the terrain world; the banded branch picked by
    `auto` at the banded level's full capacity, with hulls and the slab."""
    props = PS.props_world().world.modules["physics"].statics()
    assert props.has_convex and len(props.sdf_colliders) == 2 and props.has_ccd
    assert props.n_instanced == 5 and not props.sap and not props.pruned
    assert props.ccd_mask.sum() == 3 and len(props.conv_pair_a) > 0
    drive = PS.drive_world().world.modules["physics"].statics()
    assert drive.has_vehicles and drive.wheel_mask.sum() == 4 and drive.ctrl_mask.sum() == 1
    terrain = PS.terrain_world().world.modules["physics"].statics()
    assert terrain.heightfield_terrain == 0 and not terrain.ground_plane
    assert terrain.contact_body_a.shape[0] >= 4 * terrain.nb    # the heightfield's slots
    level = PS.banded_props_level(hulls=8).world.modules["physics"]
    st = level.statics()
    assert level.actors.capacity >= 1024 and st.sap and st.has_convex and st.sdf_colliders


def test_k2_plan_covers_the_scenes():
    """Each all-pairs world's contact slots fit K2's plan at its NB (the
    plan raises beyond its limit), C a multiple of 4."""
    from lumixengine_tpu_torch.ops import solver as S

    for builder in (PS.props_world, PS.drive_world, PS.terrain_world):
        st = builder().world.modules["physics"].statics()
        assert st.n_contact_slots % 4 == 0
        assert st.n_contact_slots <= S.k2_max_c(st.nb)
        S.k2_plan(st.nb, st.n_contact_slots)


def _run_port(sc, kind, frames):
    """`frames` frames of the scene on the port alone, W=1, on the CPU.
    Returns (state, chassis or CCD trace [frames, 3, T], ray hits)."""
    state = PS.start_state(sc, "cpu")
    step = sc.engine.build_step(sc.world, "cpu")
    offs, dirs = (torch.as_tensor(a) for a in PS.drive_rays())
    trace, hits = [], 0
    for f in range(frames):
        state = step(PS.scene_inputs(kind, sc, state, f), PS.DT)
        if sc.trace:
            trace.append(state.modules["physics"].pos[:, sc.trace])
        if kind == "drive":
            hits += int(PS.drive_queries(sc, state, offs, dirs)[0][0].sum())
    return state, (torch.stack(trace).numpy() if trace else None), hits


def test_props_physical_checks_on_the_port():
    """The JAX tests' bounds (tests/test_physics_convex.py, test_physics_ext.py)
    on the port's props world after their 300 frames."""
    sc = PS.props_world()
    state, trace, _ = _run_port(sc, "props", PS.PROPS_FRAMES)
    ms = state.modules["physics"]
    print(PS.check_props(sc, ms.pos.numpy(), ms.vel.numpy(), trace))


def test_drive_physical_checks_on_the_port():
    sc = PS.drive_world()
    state, trace, hits = _run_port(sc, "drive", PS.DRIVE_FRAMES)
    ms = state.modules["physics"]
    player_x = float(state.world.pos[0, sc.world.slot(sc.ents["player"])])
    print(PS.check_drive(sc, ms.pos.numpy(), ms.angvel.numpy(), trace, ms.ctrl_pos.numpy(),
                         ms.ctrl_grounded.numpy(), player_x, hits))


def test_terrain_physical_checks_on_the_port():
    sc = PS.terrain_world()
    state, _, _ = _run_port(sc, "terrain", PS.TERRAIN_FRAMES)
    ms = state.modules["physics"]
    walker = state.world.pos[:, sc.world.slot(sc.ents["walker"])].numpy()
    print(PS.check_terrain(sc, ms.pos.numpy(), sc.world.modules["physics"].statics().radius,
                           ms.ctrl_pos.numpy(), ms.ctrl_grounded.numpy(), walker))


def test_banded_props_physical_checks_on_the_port():
    """The banded pile test's checks (tests/test_physics_convex.py) on the
    port's level scaled down to 4 stacks of 5 hulls on the slab, at the
    level's window (at that test's 7 the falling stacks drop contacts),
    after its 360 steps, hull by hull: finite, settled, no vertex deeper
    than 2 cm in the slab or the ground, and the window certificate 0 in
    every step."""
    from lumixengine_tpu_torch.ops import convex_ops as CV

    sc = stacked_banded(neighbors=PS.BANDED_PROPS_WINDOW)
    pm = sc.world.modules["physics"]
    state = PS.start_state(sc, "cpu")
    step = sc.engine.build_step(sc.world, "cpu")
    miss = 0
    for _ in range(PS.BANDED_PROPS_STEPS):
        state = step(state, PS.DT)
        miss += int(state.modules["physics"].counters["sap_window_miss"])
    ms = state.modules["physics"]
    st = pm.statics()
    vw = CV.polytope_world_verts(ms.pos, ms.rot, st.on("cpu", pm.system).poly_verts).numpy()
    slots = list(sc.slots.values())
    pen = PS.hull_penetration(vw[..., slots], st.poly_vert_valid[:, slots])
    print(PS.check_banded_props(sc, ms.pos.numpy(), ms.vel.numpy(), pen), "miss", miss)
    assert miss == 0
