"""The animation components and nodes beyond the locomotion blend, in the
port against the JAX package on the CPU: FABRIK (ops/ik.py), the Select,
Switch, Blend2D, IKNode and Layers nodes over frames whose inputs change,
the module on the scenes of tests/test_animation_ext.py (Blend2D, the IK
arm, the property animator on a light, Select's cross-fade and clock
reset) built by both packages, and the layered crowd of
models/demo_scenes.py (every node at once, 8 point lights and a platform
under property animators) at W=2 for 10 frames.

Tolerances: clocks, slot clips and masks exact; slot weights and times
CLOCK_ATOL; IK chains IK_ATOL (5 FABRIK passes of rsqrt-normalized steps);
poses, palettes and transforms POSE_ATOL; property rows PROPERTY_ATOL."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.animation import controller as pctl
from lumixengine_tpu_torch.models import demo_scenes as pds
from lumixengine_tpu_torch.ops import ik as pik
from test_torch_bridge import ref_from_numpy, ref_to_numpy

torch.set_num_threads(2)

CLOCK_ATOL = 1e-6
IK_ATOL = 1e-5
POSE_ATOL = 1e-5
PROPERTY_ATOL = 1e-6
DT = np.float32(1.0 / 60.0)
AH = "modules.animation."


def jax_api():
    from lumixengine_tpu.animation import animation, controller
    from lumixengine_tpu.animation.module import AnimationSystem
    from lumixengine_tpu.engine.engine import Engine
    from lumixengine_tpu.renderer.model import Model, make_humanoid_skeleton
    from lumixengine_tpu.renderer.render_module import RendererSystem

    return SimpleNamespace(Engine=Engine, RendererSystem=RendererSystem, Model=Model,
                           make_humanoid_skeleton=make_humanoid_skeleton,
                           AnimationSystem=AnimationSystem,
                           make_walk_clip=animation.make_walk_clip, nodes=controller)


def _chains(seed=0, worlds=2, L=5, a=7):
    rng = np.random.default_rng(seed)
    steps = rng.normal(0.0, 0.3, (worlds, 3, L - 1, a)) + np.array([0.4, 0.0, 0.0])[:, None, None]
    joints = np.concatenate([rng.normal(0, 0.1, (worlds, 3, 1, a)),
                             np.cumsum(steps, axis=2)], axis=2)
    joints[..., 1:, :] += joints[..., :1, :]
    target = rng.normal(0.0, 0.8, (worlds, 3, a))
    target[..., :2] = joints[..., -1, :2] + 5.0       # out of reach: the chain stretches
    return joints.astype(np.float32), target.astype(np.float32)


@pytest.mark.parametrize("alpha", ["one", "per_animator"])
def test_ik_ops_match_reference(alpha):
    from lumixengine_tpu.ops import ik as rik

    joints, target = _chains()
    a = 1.0 if alpha == "one" else np.linspace(0.0, 1.0, joints.shape[-1]).astype(np.float32)
    a_t = a if alpha == "one" else torch.tensor(a).expand(2, -1)
    a_j = a if alpha == "one" else jnp.broadcast_to(jnp.asarray(a), (2, a.shape[0]))
    got = pik.apply_ik(torch.tensor(joints), torch.tensor(target), a_t)
    ref = rik.apply_ik(jnp.asarray(joints), jnp.asarray(target), a_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=IK_ATOL)
    solved = pik.fabrik(torch.tensor(joints), torch.tensor(target))
    np.testing.assert_allclose(solved.numpy(), np.asarray(rik.fabrik(jnp.asarray(joints),
                                                                     jnp.asarray(target))),
                               rtol=0, atol=IK_ATOL)
    dq = pik.chain_rotation_deltas(torch.tensor(joints), solved)
    rq = rik.chain_rotation_deltas(jnp.asarray(joints), jnp.asarray(solved.numpy()))
    np.testing.assert_allclose(dq.numpy(), np.asarray(rq), rtol=0, atol=IK_ATOL)
    # the chain keeps its bone lengths; out of reach it stretches toward the target
    sol = solved.numpy()
    seg = np.linalg.norm(np.diff(sol, axis=-2), axis=-3)
    np.testing.assert_allclose(seg, np.linalg.norm(np.diff(joints, axis=-2), axis=-3), atol=1e-4)
    to_end = sol[..., -1, :2] - sol[..., 0, :2]
    to_target = target[..., :2] - sol[..., 0, :2]
    cos = np.sum(to_end * to_target, axis=-2) / (np.linalg.norm(to_end, axis=-2)
                                                 * np.linalg.norm(to_target, axis=-2))
    assert cos.min() > 0.999, cos


def _node(m, kind):
    """Controller root `kind` over clips 0-4, in package module `m`."""
    leaf = m.AnimationNode
    if kind == "Select":
        return m.Select(m.Input(0), [leaf(0), leaf(1), leaf(2)], blend_length=0.05)
    if kind == "Switch":
        return m.Switch(m.Input(2), m.Select(m.Input(0), [leaf(0), leaf(1)], blend_length=0.0),
                        leaf(3), blend_length=0.05)
    if kind == "Blend2D":
        return m.Blend2D(m.Input(0), m.Input(1), [((0.0, 1.0), leaf(0)), ((1.0, 0.0), leaf(1)),
                                                  ((-1.0, 0.0), leaf(2)), ((0.0, -1.0), leaf(3))])
    if kind == "IKNode":
        return m.IKNode(leaf(4), chain=[1, 2, 3], target_inputs=(0, 1, 2), alpha=3)
    mask = np.arange(32) % 3 == 0
    return m.Layers([(m.Blend2D(m.Input(0), m.Input(1), [((0.0, 1.0), leaf(0)),
                                                          ((1.0, 0.0), leaf(1))]), None, 1.0),
                     (m.Switch(m.Input(2), leaf(2), leaf(3)), mask, 0.7), (leaf(4), ~mask, 0.3)])


@pytest.fixture(scope="module")
def banks():
    """The layered crowd's anim systems (its 8 clips on the humanoid) in
    both packages."""
    return (pds.layered_crowd_world(2, api=jax_api())[1].modules["animation"].system,
            pds.layered_crowd_world(2)[1].modules["animation"].system)


@pytest.mark.parametrize("kind", ["Select", "Switch", "Blend2D", "IKNode", "Layers"])
def test_node_matches_reference(banks, kind):
    """12 frames of Controller.eval in both packages, the inputs switched at
    frames 3 and 7 (a cross-fade, a hard switch, a clock reset): slots,
    masks, IK requests and clocks."""
    from lumixengine_tpu.animation import controller as rctl

    rsys, psys = banks
    rc = rctl.Controller(kind, rsys.bank_statics, _node(rctl, kind), inputs=list("abcd"))
    pc = pctl.Controller(kind, psys.bank_statics, _node(pctl, kind), inputs=list("abcd"))
    assert rc.num_clocks == pc.num_clocks and len(rc.ik_requests) == len(pc.ik_requests)
    rng = np.random.default_rng(4)
    a = 9
    inputs = np.stack([rng.integers(0, 3, a), rng.uniform(-1, 1, a), rng.integers(0, 2, a),
                       rng.uniform(0, 1, a)]).astype(np.float32)
    clocks = np.zeros((rc.num_clocks, a), np.float32)
    fades = 0
    for frame in range(12):
        if frame in (3, 7):
            inputs[0] = (inputs[0] + 1) % 3
            inputs[1] = -inputs[1]
            inputs[2] = 1 - inputs[2]
        rs, rm, rnew = rc.eval(jnp.asarray(inputs), jnp.asarray(clocks), jnp.float32(DT))
        ps, pm, pnew = pc.eval(torch.tensor(inputs), torch.tensor(clocks), torch.tensor(DT))
        assert len(ps) == len(rs) and sorted(pm) == sorted(rm)
        for s in pm:
            np.testing.assert_array_equal(pm[s].numpy(), np.asarray(rm[s]))
        for (pcl, pt, pw, pprev), (rcl, rt, rw, rprev) in zip(ps, rs):
            np.testing.assert_array_equal(pcl.numpy(), np.asarray(rcl))
            for g, r in ((pt, rt), (pw, rw), (pprev, rprev)):
                np.testing.assert_allclose(np.broadcast_to(g.numpy(), (a,)),
                                           np.broadcast_to(np.asarray(r), (a,)), rtol=0,
                                           atol=CLOCK_ATOL)
        np.testing.assert_allclose(pnew.numpy(), np.asarray(rnew), rtol=0, atol=CLOCK_ATOL)
        weights = np.stack([np.broadcast_to(s[2].numpy(), (a,)) for s in ps])
        fades += int(((weights > 1e-6) & (weights < 1 - 1e-6)).any())
        clocks = pnew.numpy()
    if kind in ("Select", "Switch", "Blend2D", "Layers"):
        assert fades > 0, "no frame blended two slots"


# -- the module on the JAX tests' scenes --------------------------------------------------

def _scene(api, kind):
    """tests/test_animation_ext.py's scene `kind`, built with `api`:
    (engine, world, entity)."""
    engine = api.Engine()
    engine.module_capacities = {"model_instances": 32, "animables": 8, "animators": 8}
    renderer = api.RendererSystem(engine)
    n = api.nodes
    if kind == "ik":
        parent = np.array([-1, 0, 1, 2, 3, 4], np.int32)
        pos = np.zeros((6, 3), np.float32)
        pos[1:, 0] = 0.5
        rot = np.tile(np.array([0, 0, 0, 1.0], np.float32), (6, 1))
        sk = type(api.make_humanoid_skeleton(2))(bone_parent=parent, bind_pos=pos, bind_rot=rot)
    else:
        sk = api.make_humanoid_skeleton(16 if kind == "blend2d" else 8,
                                        seed=3 if kind == "blend2d" else 9)
    renderer.add_model(api.Model(name="character", bounding_radius=1.0, skeleton=sk))
    engine.add_system(renderer)
    anim = api.AnimationSystem(engine, renderer=renderer)
    if kind == "blend2d":
        for i, name in enumerate(["n", "e", "w", "s"]):
            anim.add_clip(api.make_walk_clip(sk, name, frames=15, amplitude=0.3, seed=20 + i))
        root = n.Blend2D(n.Input(0), n.Input(1),
                         [((0.0, 1.0), n.AnimationNode(0)), ((1.0, 0.0), n.AnimationNode(1)),
                          ((-1.0, 0.0), n.AnimationNode(2)), ((0.0, -1.0), n.AnimationNode(3))])
        inputs = {"a": 0.3, "b": 0.8}
    elif kind == "ik":
        anim.add_clip(api.make_walk_clip(sk, "idle", frames=9, amplitude=0.0, seed=1))
        root = n.IKNode(n.AnimationNode(0), chain=[1, 2, 3, 4, 5], target_inputs=(0, 1, 2),
                        alpha=1.0)
        inputs = {"a": 1.0, "b": 1.0, "c": 0.5}
    else:
        anim.add_clip(api.make_walk_clip(sk, "a", frames=31, amplitude=0.2, seed=1))
        anim.add_clip(api.make_walk_clip(sk, "b", frames=31, amplitude=0.6, seed=2))
        root = n.Select(n.Input(0), [n.AnimationNode(0), n.AnimationNode(1)], blend_length=0.2)
        inputs = {"a": 0.0}
    anim.add_controller(n.Controller("ctrl", anim.bank_statics, root, inputs=["a", "b", "c"]))
    engine.add_system(anim)
    world = engine.create_world(capacity=32)
    e = world.create_entity()
    world.create_component(e, "model_instance", model="character")
    world.create_component(e, "animator", controller="ctrl", inputs=inputs)
    light = world.create_entity()
    world.create_component(light, "point_light", intensity=1.0)
    world.create_component(light, "property_animator", curves=[{
        "component": "point_light", "property": "intensity",
        "times": [0.0, 1.0, 2.0], "values": [0.0, 10.0, 0.0]}])
    return engine, world, e


def _compare(got, ref, fields=("pose_pos", "pose_rot", "palette")):
    for k in ("ctrl_clocks", "ctrl_inputs", "an_time", "pa_enabled"):
        np.testing.assert_allclose(got[AH + k], ref[AH + k], rtol=0, atol=CLOCK_ATOL, err_msg=k)
    for k in fields:
        np.testing.assert_allclose(got[AH + k], ref[AH + k], rtol=0, atol=POSE_ATOL, err_msg=k)
    for k in ("local.pos", "local.rot", "world.pos", "world.rot"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=POSE_ATOL, err_msg=k)
    for k in ("modules.renderer.pl_intensity", "modules.renderer.pl_range",
              "modules.renderer.cam_fov"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=PROPERTY_ATOL, err_msg=k)


@pytest.mark.parametrize("kind", ["blend2d", "ik", "select"])
def test_module_on_the_reference_scenes(kind):
    """45 frames of each JAX test's scene in both packages (the select
    switched at frame 10), compared every frame; then that test's own
    check on the port."""
    rengine, rworld, _re = _scene(jax_api(), kind)
    pengine, pworld, pe = _scene(pds.anim_api(), kind)
    rstep = jax.jit(rengine.build_step(rworld, jit=False))
    pstep = pengine.build_step(pworld, "cpu")
    tree = ref_to_numpy(rworld.device_state())
    own = bridge.state_to_numpy(pworld.device_state("cpu"))
    assert set(own) == set(tree)
    for k, v in own.items():
        np.testing.assert_array_equal(v, tree[k], err_msg=k)
    rstate, pstate = rworld.device_state(), pworld.device_state("cpu")
    amod = pworld.modules["animation"]
    slot = amod.animators.slot_of(pe)
    for frame in range(45):
        if kind == "select" and frame == 10:
            rms = rstate.modules["animation"]
            rstate = rstate.replace(modules={**rstate.modules, "animation": rms.replace(
                ctrl_inputs=rms.ctrl_inputs.at[0, slot].set(1.0))})
            pms = pstate.modules["animation"]
            ci = pms.ctrl_inputs.clone()
            ci[0, slot] = 1.0
            pstate = pstate.replace(modules={**pstate.modules,
                                             "animation": pms.replace(ctrl_inputs=ci)})
        rstate, pstate = rstep(rstate, jnp.float32(DT)), pstep(pstate, torch.tensor(DT))
        _compare(bridge.state_to_numpy(pstate), ref_to_numpy(rstate))
    ms = pstate.modules["animation"]
    col = amod.pool_col_animator(slot)
    if kind == "ik":
        np.testing.assert_allclose(ms.pose_pos[:, 5, col].numpy(), [1.0, 1.0, 0.5], atol=0.05)
    elif kind == "select":
        assert float(ms.ctrl_clocks[1, slot]) > 0.5     # b's clock restarted at the switch
    light = pworld.modules["renderer"].point_lights
    assert float(pstate.modules["renderer"].pl_intensity[light.slot_of(pe + 1)]) > 5.0


def test_property_animator_targets():
    """A target without a device row raises KeyError, as in the reference;
    destroying the component drops its curves and its enable flag."""
    engine, world, e = _scene(pds.anim_api(), "select")
    am = world.modules["animation"]
    with pytest.raises(KeyError, match="no device row"):
        world.create_component(e, "property_animator", curves=[{
            "component": "point_light", "property": "color", "times": [0.0], "values": [1.0]}])
    assert len(am.property_animators) == 1
    world.destroy_component(e + 1, "property_animator")
    assert not am.property_animators
    state = world.device_state("cpu")
    assert state.modules["animation"].pa_enabled.tolist() == [True]
    state = engine.build_step(world, "cpu")(state, torch.tensor(DT))
    assert float(state.modules["renderer"].pl_intensity[0]) == 1.0   # left as set


# -- the layered crowd ------------------------------------------------------------------

def test_layered_crowd_matches_reference():
    """The layered crowd (16 characters) at W=2 diverging worlds, 10
    frames with the cull pass, in both packages: poses, palettes, clocks,
    transforms and the animated rows; then its IK and property checks on
    the port."""
    from lumixengine_tpu.parallel.mesh import replicate_state as ref_replicate

    rengine, rworld, _rh = pds.layered_crowd_world(16, api=jax_api())
    pengine, pworld, handles = pds.layered_crowd_world(16)
    rstep = jax.jit(jax.vmap(rengine.build_step(rworld, jit=False,
                                                extra=rworld.modules["renderer"].cull_pass),
                             in_axes=(0, None)))
    pstep = pengine.build_step(pworld, "cpu", extra=pworld.modules["renderer"].cull_pass)
    tree = ref_to_numpy(ref_replicate(rworld.device_state(), 2, jax.random.PRNGKey(3)))
    rstate, pstate = ref_from_numpy(ref_replicate(rworld.device_state(), 2), tree), \
        bridge.state_from_numpy(tree, "cpu")
    for _ in range(10):
        time = pstate.time.numpy().copy()
        rstate, pstate = rstep(rstate, jnp.float32(DT)), pstep(pstate, torch.tensor(DT))
        got = bridge.state_to_numpy(pstate)
        _compare(got, ref_to_numpy(rstate))
    dist, reachable = pds.ik_gaps(pworld, pstate, handles)
    assert reachable.mean() > 0.5 and dist[reachable].max() < pds.IK_REACH_ATOL, dist.max()
    for w in range(2):
        state_w = bridge.state_from_numpy({k: v[w] for k, v in got.items()}, "cpu")
        for name, rows, want in pds.property_rows(pworld, state_w, float(time[w]), handles):
            assert abs(float(rows) - want) <= PROPERTY_ATOL, (name, float(rows), want)
    masks = pworld.modules["animation"].system.controllers[0].root.layers
    assert masks[1][1].any() and masks[2][1][handles["chain"]].all()
