"""The port's PhysicsModule against the JAX package's, frame by frame, on
scenes built by both packages from one spec: one sphere with no ground, a
stack of three boxes, a dynamic sphere on a moved kinematic platform, the
layer filter, capsules on the ground and against a sphere, and the joints
(spherical pendulum, hinge off-axis spin, hinge drive, hinge limit, distance
band, d6 per-axis motion). All of them run the all-pairs branch. The JAX
module runs its fused Pallas contact solve in interpret mode, the semantics
kernel K2 ports; the port runs K2's plain version on the CPU."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu_torch import bridge
from test_torch_bridge import DT, ref_from_numpy, ref_to_numpy, use_fused_solver

torch.set_num_threads(1)

BODY_POS_ATOL = 1e-3    # pos, rot: solver sums reordered, errors grow over the frames
BODY_VEL_ATOL = 5e-3    # vel, angvel, lambdas: the JAX package's own fused-vs-jnp bound
PH = "modules.physics."


def _packages():
    from lumixengine_tpu.engine.engine import Engine as REngine
    from lumixengine_tpu.physics.module import PhysicsSystem as RSystem
    from lumixengine_tpu_torch.engine.engine import Engine as PEngine
    from lumixengine_tpu_torch.physics.module import PhysicsSystem as PSystem
    return {"jax": (REngine, RSystem), "torch": (PEngine, PSystem)}


def build(pkg, actors=8, joints=8, gravity=(0.0, -9.81, 0.0), ground=True, damping=None):
    engine_cls, system_cls = _packages()[pkg]
    engine = engine_cls()
    engine.module_capacities = {"actors": actors, "joints": joints}
    phys = system_cls(engine, gravity=gravity)
    phys.ground_plane = ground
    if damping is not None:
        phys.linear_damping, phys.angular_damping = damping
    engine.add_system(phys)
    return engine, engine.create_world(capacity=actors + 8), phys


# -- the scenes: spec(pkg) -> (engine, world, {dotted name: (index, value)} edits) --

def sphere_no_ground(pkg):
    engine, world, _ = build(pkg, ground=False)
    e = world.create_entity(position=(0.0, 10.0, 0.0))
    world.create_component(e, "rigid_actor", motion="dynamic", shape="sphere", radius=0.5)
    slot = world.modules["physics"].actors.slot_of(e)
    return engine, world, {PH + "vel": ((slice(None), slot), (1.0, 4.0, -0.5)),
                           PH + "angvel": ((slice(None), slot), (0.3, -2.0, 1.0))}


def stack3(pkg):
    engine, world, _ = build(pkg)
    for i in range(3):
        e = world.create_entity(position=(0.02 * i, 0.51 + 1.01 * i, 0.0))
        world.create_component(e, "rigid_actor", motion="dynamic", shape="box",
                               half_extents=(0.5, 0.5, 0.5), friction=0.6)
    return engine, world, {}


def kinematic_platform(pkg):
    """A sphere falls on a kinematic platform whose entity was moved before
    the first frame: the platform takes the entity's pose, the sphere lands
    on it."""
    engine, world, _ = build(pkg)
    plat = world.create_entity(position=(0.0, 1.0, 0.0))
    world.create_component(plat, "rigid_actor", motion="kinematic", shape="box",
                           half_extents=(1.5, 0.2, 1.5))
    ball = world.create_entity(position=(0.4, 2.2, 0.0))
    world.create_component(ball, "rigid_actor", motion="dynamic", shape="sphere", radius=0.3)
    return engine, world, {"local.pos": ((slice(None), world.slot(plat)), (0.5, 1.2, 0.0))}


def layer_filter(pkg):
    engine, world, phys = build(pkg, gravity=(0.0, 0.0, 0.0), ground=False)
    phys.set_layers_collide(1, 2, False)
    for x, layer in ((-0.4, 1), (0.4, 2), (0.0, 0)):
        e = world.create_entity(position=(x, 0.3 * (layer == 0), 0.0))
        world.create_component(e, "rigid_actor", motion="dynamic", shape="sphere", radius=0.5,
                               layer=layer)
    return engine, world, {}


def capsule_on_ground(pkg):
    engine, world, _ = build(pkg)
    e = world.create_entity(position=(0.0, 3.0, 0.0))
    world.create_component(e, "rigid_actor", motion="dynamic", shape="capsule", radius=0.3,
                           half_extents=(0.3, 0.5, 0.3))
    slot = world.modules["physics"].actors.slot_of(e)
    return engine, world, {PH + "angvel": ((slice(None), slot), (0.0, 0.0, 1.5))}


def capsule_sphere(pkg):
    engine, world, phys = build(pkg, gravity=(0.0, 0.0, 0.0), ground=False)
    phys.linear_damping = 0.0
    a = world.create_entity(position=(-2.0, 0.0, 0.0))
    b = world.create_entity(position=(1.0, 0.0, 0.0))
    world.create_component(a, "rigid_actor", motion="dynamic", shape="sphere", radius=0.5,
                           friction=0.0)
    world.create_component(b, "rigid_actor", motion="dynamic", shape="capsule", radius=0.4,
                           half_extents=(0.4, 0.6, 0.4), friction=0.0)
    slot = world.modules["physics"].actors.slot_of(a)
    return engine, world, {PH + "vel": ((0, slot), 3.0)}


def spherical_pendulum(pkg):
    engine, world, _ = build(pkg, ground=False)
    pivot = world.create_entity(position=(0.0, 5.0, 0.0))
    bob = world.create_entity(position=(1.5, 5.0, 0.0))
    world.create_component(pivot, "rigid_actor", motion="static", shape="sphere", radius=0.1)
    world.create_component(bob, "rigid_actor", motion="dynamic", shape="sphere", radius=0.2)
    j = world.create_entity()
    world.create_component(j, "spherical_joint", body_a=pivot, body_b=bob,
                           anchor_a=(0.0, 0.0, 0.0), anchor_b=(-1.5, 0.0, 0.0))
    return engine, world, {}


def hinge_off_axis(pkg):
    engine, world, phys = build(pkg, gravity=(0.0, 0.0, 0.0), ground=False)
    phys.angular_damping = 0.0
    a = world.create_entity(position=(0.0, 0.0, 0.0))
    b = world.create_entity(position=(1.0, 0.0, 0.0))
    world.create_component(a, "rigid_actor", motion="static", shape="box",
                           half_extents=(0.2, 0.2, 0.2))
    world.create_component(b, "rigid_actor", motion="dynamic", shape="box",
                           half_extents=(0.3, 0.3, 0.3))
    j = world.create_entity()
    world.create_component(j, "hinge_joint", body_a=a, body_b=b, axis=(0, 1, 0),
                           anchor_a=(0.5, 0, 0), anchor_b=(-0.5, 0, 0))
    slot = world.modules["physics"].actors.slot_of(b)
    return engine, world, {PH + "angvel": ((slice(None), slot), (3.0, 2.0, 0.0))}


def _hinged_pair(pkg, **hinge):
    engine, world, phys = build(pkg, actors=4, joints=4, gravity=(0.0, 0.0, 0.0), ground=False)
    phys.angular_damping = 0.0
    a = world.create_entity(position=(0.0, 2.0, 0.0))
    world.create_component(a, "rigid_actor", motion="static", shape="box")
    b = world.create_entity(position=(0.0, 2.0, 0.0))
    world.create_component(b, "rigid_actor", motion="dynamic", shape="box")
    j = world.create_entity()
    world.create_component(j, "hinge_joint", body_a=a, body_b=b, axis=(0.0, 1.0, 0.0), **hinge)
    return engine, world, world.modules["physics"].actors.slot_of(b)


def hinge_drive(pkg):
    engine, world, _slot = _hinged_pair(pkg, drive_velocity=3.0, drive_force=1e6)
    return engine, world, {}


def hinge_limit(pkg):
    engine, world, slot = _hinged_pair(pkg, limit=(-0.5, 0.5))
    return engine, world, {PH + "angvel": ((1, slot), 4.0)}


def distance_band(pkg):
    engine, world, _ = build(pkg, actors=4, joints=4, ground=False)
    a = world.create_entity(position=(0.0, 5.0, 0.0))
    world.create_component(a, "rigid_actor", motion="static", shape="sphere", radius=0.1)
    b = world.create_entity(position=(0.0, 4.5, 0.0))
    world.create_component(b, "rigid_actor", motion="dynamic", shape="sphere", radius=0.1)
    j = world.create_entity()
    world.create_component(j, "distance_joint", body_a=a, body_b=b, min_distance=0.2,
                           max_distance=1.0)
    return engine, world, {}


def d6_per_axis(pkg):
    engine, world, phys = build(pkg, actors=4, joints=4, ground=False)
    phys.layer_matrix[0, 1] = phys.layer_matrix[1, 0] = False
    a = world.create_entity(position=(0.0, 5.0, 0.0))
    world.create_component(a, "rigid_actor", motion="static", shape="box")
    b = world.create_entity(position=(0.3, 5.0, 0.2))
    world.create_component(b, "rigid_actor", motion="dynamic", shape="box", mass=1.0, layer=1)
    j = world.create_entity()
    world.create_component(j, "d6_joint", body_a=a, body_b=b, linear_motion=(1, 0, 1),
                           angular_motion=(1, 1, 1))
    slot = world.modules["physics"].actors.slot_of(b)
    return engine, world, {PH + "angvel": ((1, slot), 2.0)}


SCENES = {  # name: (spec, frames, contacts expected)
    "sphere_no_ground": (sphere_no_ground, 40, False),
    "stack3": (stack3, 60, True),
    "kinematic_platform": (kinematic_platform, 60, True),
    "layer_filter": (layer_filter, 30, True),
    "capsule_on_ground": (capsule_on_ground, 60, True),
    "capsule_sphere": (capsule_sphere, 60, True),
    "spherical_pendulum": (spherical_pendulum, 60, False),
    "hinge_off_axis": (hinge_off_axis, 60, False),
    "hinge_drive": (hinge_drive, 60, True),      # the two boxes share a place
    "hinge_limit": (hinge_limit, 60, True),
    "distance_band": (distance_band, 60, False),
    "d6_per_axis": (d6_per_axis, 60, False),     # the pair is filtered by layer
}


def jax_step(engine, world, monkeypatch):
    """The reference's build_step, jitted, with its physics on the fused
    Pallas solve in interpret mode."""
    use_fused_solver(monkeypatch, world)
    return jax.jit(engine.build_step(world, jit=False))


def compare_physics(got, ref, errs, where=""):
    """The physics fields and the body transforms, port vs reference, at the
    stated tolerances; counters, sleep and pair keys exactly."""
    def close(k, atol):
        err = float(np.abs(got[k] - ref[k]).max(initial=0.0))
        errs[k] = max(errs.get(k, 0.0), err)
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k + where)

    for f in ("pos", "rot"):
        close(PH + f, BODY_POS_ATOL)
        close("local." + f, BODY_POS_ATOL)
        close("world." + f, BODY_POS_ATOL)
    for f in ("vel", "angvel", "lam_n", "lam_t1", "lam_t2", "sap_lam", "sap_glam"):
        close(PH + f, BODY_VEL_ATOL)
    for f in ("sleep", "pair_key", "sap_rank", "counters.active_contacts",
              "counters.sap_window_miss", "counters.pruned_pair_miss", "frame"):
        k = f if f == "frame" else PH + f
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k + where)


def run_both(rengine, rworld, pengine, pworld, tree, frames, monkeypatch, batched=False):
    """`frames` frames from the numpy state `tree` in both packages, compared
    after every frame. Returns (max abs errors by field and the most active
    contacts of a frame, the last two numpy states)."""
    rstep = jax_step(rengine, rworld, monkeypatch)
    if batched:
        rstep = jax.jit(jax.vmap(rengine.build_step(rworld, jit=False), in_axes=(0, None)))
    pstep = pengine.build_step(pworld, "cpu")
    rstate = ref_from_numpy(rworld.device_state() if not batched else _batched_template(
        rworld, tree), tree)
    pstate = bridge.state_from_numpy(tree, "cpu")
    errs = {"active_contacts": 0}
    for f in range(frames):
        rstate = rstep(rstate, jnp.float32(DT))
        pstate = pstep(pstate, DT)
        got, ref = bridge.state_to_numpy(pstate), ref_to_numpy(rstate)
        compare_physics(got, ref, errs, where=f" (frame {f + 1})")
        errs["active_contacts"] = max(errs["active_contacts"],
                                      int(got[PH + "counters.active_contacts"].max()))
    return errs, got, ref


def _batched_template(rworld, tree):
    from lumixengine_tpu.parallel.mesh import replicate_state as ref_replicate

    return ref_replicate(rworld.device_state(), tree["frame"].shape[0])


def scene_tree(spec):
    """Both packages' builds of `spec`, and the start state as numpy: the
    reference's device state with the spec's edits. The port's own device
    state equals the reference's, field for field."""
    rengine, rworld, edits = spec("jax")
    pengine, pworld, _ = spec("torch")
    tree = ref_to_numpy(rworld.device_state())
    own = bridge.state_to_numpy(pworld.device_state("cpu"))
    assert set(own) == {k for k in tree if not bridge.is_skipped(k)}
    for k, v in own.items():
        assert (v.dtype, v.shape) == (tree[k].dtype, tree[k].shape), k
        np.testing.assert_allclose(v, tree[k], rtol=0, atol=1e-6, err_msg=k)
    for k, (idx, value) in edits.items():
        tree[k] = tree[k].copy()
        tree[k][idx] = value
    return rengine, rworld, pengine, pworld, tree


@pytest.mark.parametrize("name", list(SCENES))
def test_module_matches_reference_frame_by_frame(name, monkeypatch):
    spec, frames, contacts = SCENES[name]
    rengine, rworld, pengine, pworld, tree = scene_tree(spec)
    assert not pworld.modules["physics"].statics().pruned
    assert not pworld.modules["physics"].statics().sap
    errs, got, ref = run_both(rengine, rworld, pengine, pworld, tree, frames, monkeypatch)
    print(f"{name}: {frames} frames, max abs err", {k: f"{v:.2e}" for k, v in errs.items() if v})
    assert (errs["active_contacts"] > 0) == contacts, errs["active_contacts"]
    moved = np.abs(got[PH + "pos"] - tree[PH + "pos"]).max()
    assert moved > 1e-3, "the scene did not move"


def test_scenes_exercise_what_they_name():
    """Each scene reaches the feature it names: contacts where there is a
    ground or a pair, joints where there are joints, the filtered pair left
    out, the kinematic body moved to its entity."""
    def statics(spec):
        _e, world, _ = spec("torch")
        return world.modules["physics"].statics()

    assert len(statics(layer_filter).pair_a) == 2           # 0-1 and 0-2; 1-2 filtered
    assert statics(kinematic_platform).kin_mask.sum() == 1
    assert statics(capsule_sphere).any_caps and statics(capsule_on_ground).any_caps
    for spec, jt in ((spherical_pendulum, 1), (hinge_off_axis, 2), (hinge_drive, 2),
                     (hinge_limit, 2), (distance_band, 0), (d6_per_axis, 3)):
        assert statics(spec).joint_type.tolist() == [jt]
    assert statics(d6_per_axis).has_d6_config
    assert len(statics(d6_per_axis).pair_a) == 0           # filtered by the layer matrix


def test_all_pairs_world_batch(monkeypatch):
    """The all-pairs branch on a batch of 3 worlds that diverge (the
    reference under vmap): the stack of boxes, 20 frames."""
    from lumixengine_tpu.parallel.mesh import replicate_state as ref_replicate

    rengine, rworld, pengine, pworld, _tree = scene_tree(stack3)
    tree = ref_to_numpy(ref_replicate(rworld.device_state(), 3, jax.random.PRNGKey(1)))
    errs, got, _ref = run_both(rengine, rworld, pengine, pworld, tree, 20, monkeypatch,
                               batched=True)
    assert got[PH + "pos"].shape[0] == 3
    assert not np.allclose(got[PH + "pos"][0], got[PH + "pos"][1])
    print("batched stack3 max abs err", {k: f"{v:.2e}" for k, v in errs.items() if v})


def test_unported_physics_raises():
    """Every component type of the reference is accepted, and
    broadphase="sap", the last branch that raised, builds its statics (no
    static pair list, no warm-start carry) and steps the stack of boxes
    (tests/test_torch_sap.py holds the branch to the reference)."""
    engine, world, _ = stack3("torch")
    pm = world.modules["physics"]
    ref_types = ["rigid_actor", "distance_joint", "spherical_joint", "hinge_joint", "d6_joint",
                 "physics_controller", "heightfield", "vehicle", "wheel", "mesh_collider",
                 "instanced_cube", "instanced_mesh"]
    assert sorted(pm.component_types()) == sorted(ref_types)
    pm.broadphase = "sap"
    pm.invalidate_statics()
    st = pm.statics()
    assert st.sap and not st.banded and not st.pruned and len(st.pair_a) == 0
    state = world.device_state("cpu")
    assert state.modules["physics"].sap_lam.numel() == 0
    step = engine.build_step(world, "cpu")
    for _ in range(60):
        state = step(state, DT)
    ms = state.modules["physics"]
    assert torch.isfinite(ms.pos).all() and int(ms.counters["active_contacts"]) > 0
    assert int(ms.counters["sap_window_miss"]) == 0


@functools.lru_cache(maxsize=None)
def _capsule_pair_data():
    rng = np.random.default_rng(3)
    n = 64
    q = rng.normal(size=(4, n)).astype(np.float32)
    q /= np.linalg.norm(q, axis=0)
    data = dict(pa=rng.uniform(-1, 1, (3, n)), pb=rng.uniform(-1, 1, (3, n)),
                ra=rng.uniform(0.2, 0.6, n), rb=rng.uniform(0.2, 0.6, n),
                ha=rng.uniform(0.1, 0.6, (3, n)), hb=rng.uniform(0.1, 0.6, (3, n)),
                sa=rng.integers(0, 3, n), sb=rng.integers(0, 3, n))
    data = {k: v.astype(np.int32 if k in ("sa", "sb") else np.float32) for k, v in data.items()}
    data["qa"], data["qb"] = q, np.roll(q, 1, axis=1)
    return data


@pytest.mark.parametrize("fn", ["ground_contacts", "pair_contacts_from_data"])
def test_capsule_narrowphase_matches_reference(fn):
    """The capsule arms of the ground and pair narrowphase on seeded
    sphere/box/capsule data, against the JAX package."""
    from lumixengine_tpu.ops import physics_ops as RP
    from lumixengine_tpu_torch.ops import physics_ops as PP

    d = _capsule_pair_data()
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    j = {k: jnp.asarray(v) for k, v in d.items()}
    if fn == "ground_contacts":
        got = PP.ground_contacts(t["pa"], t["qa"], t["sa"].long(), t["ra"], t["ha"],
                                 torch.ones(64, dtype=torch.bool), ground_y=0.2)
        ref = RP.ground_contacts(j["pa"], j["qa"], j["sa"], j["ra"], j["ha"],
                                 jnp.ones(64, bool), ground_y=0.2)
        got, ref = got[2:], ref[2:]
    else:
        got = PP.pair_contacts_from_data(t["pa"], t["qa"], t["ra"], t["ha"], t["sa"].long(),
                                         t["pb"], t["qb"], t["rb"], t["hb"], t["sb"].long())
        ref = RP.pair_contacts_from_data(j["pa"], j["qa"], j["ra"], j["ha"], j["sa"],
                                         j["pb"], j["qb"], j["rb"], j["hb"], j["sb"])
    act_r = np.asarray(ref[3])
    np.testing.assert_array_equal(got[3].numpy(), act_r)
    assert act_r.any() and (d["sa"] == 2).any()
    for g, r in zip(got[:3], ref[:3]):
        r = np.asarray(r)
        m = np.broadcast_to(act_r, r.shape)          # inactive slots hold no contact
        np.testing.assert_allclose(g.numpy()[m], r[m], rtol=0, atol=2e-6)
