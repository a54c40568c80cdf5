"""The JAX classes' last public members in the port, against the JAX package
on the CPU, and the fault they hid: a reflected property edit
(`registry.set_property`, as the editor's SetPropertyCommand, a Lua write
and a script's set_property make it) must reach the render and animation
statics, which the reflection setter drops through `invalidate_statics`.

- The fault: `headless_demo_world(256)` in both packages, one frame, every
  model instance re-pointed to (old + 1) mod 4 through the registry, both
  steps rebuilt, then 3 frames: `mi_lod`, `mi_visible` and `mi_model` equal
  in every slot. The flagship at test size with its animables' clip and
  time_scale, its animators' controller and one animator input edited:
  poses and palettes within POSE_ATOL over 3 frames.
- `RenderModule.set_model`, `AnimationModule.set_animator_input`, the
  constructor's `max_controller_inputs` and `build_palettes`,
  `AnimationSystem(max_bones=...)`, `Engine.resources`,
  `World.set_rotation`/`set_scale`, `Transform.identity`/`lanes`,
  `DenseStore.mask`, `DrawStream.clear`, `Model.mesh_id`,
  `ClipRegistry.get` and `Clip.sample_host`, each on the same seeded
  inputs in both packages.

Tolerances: cull and LOD decisions, model ids, store rows and baked banks
are equal; poses and palettes within POSE_ATOL = 1e-5 (13-level compose
chains and rsqrt differ by ulps); clocks within CLOCK_ATOL = 0 (the same
adds and fmod); host transforms and the host clip sampler within
HOST_ATOL = 1e-6 (the same numpy formulas).
"""
import dataclasses
import importlib
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lumixengine_tpu_torch import bridge
from test_torch_animation import FLAGSHIP_TEST
from test_torch_bridge import DT, ref_to_numpy, reference_step

torch.set_num_threads(1)

FRAMES = 3
DEMO_ENTITIES = 256
CROWD = 4
POSE_ATOL = 1e-5
CLOCK_ATOL = 0.0
HOST_ATOL = 1e-6
R, A = "modules.renderer.", "modules.animation."
CULL_FIELDS = ("mi_lod", "mi_visible", "mi_model")
PKG = {"jax": "lumixengine_tpu", "torch": "lumixengine_tpu_torch"}


def mod(pkg, name):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


def set_property(pkg, world, entity, ctype, prop, value):
    reflection = mod(pkg, "engine.reflection")
    reflection.register_builtin_components()
    reflection.registry.set_property(world, int(entity), ctype, prop, value)


def live(store):
    return [int(e) for e in store.entity[store.entity >= 0]]


def port_step(pengine, pworld):
    return pengine.build_step(pworld, "cpu", extra=pworld.modules["renderer"].cull_pass)


def step_pair(rengine, rworld, rstate, pengine, pworld, pstate, frames, pstep=None):
    """`frames` frames of build_step(extra=cull_pass) in both packages, the
    steps built anew (after an edit; the port's `pstep` if given); returns
    the states and each frame's (port, reference) numpy trees."""
    rstep = reference_step(rengine, rworld, batched=False)
    pstep = pstep or port_step(pengine, pworld)
    trees = []
    for _ in range(frames):
        rstate = rstep(rstate, jnp.float32(DT))
        pstate = pstep(pstate, DT)
        trees.append((bridge.state_to_numpy(pstate), ref_to_numpy(rstate)))
    return rstate, pstate, trees


def start_pair(rworld):
    rstate = rworld.device_state()
    return rstate, bridge.state_from_numpy(ref_to_numpy(rstate), "cpu")


def cull_gaps(got, ref):
    return {k: int(np.count_nonzero(got[R + k] != ref[R + k])) for k in CULL_FIELDS}


# -- the fault: a property edit leaves the statics stale ------------------------------------

def demo_pair():
    return (mod("jax", "models.demo_scenes").headless_demo_world(DEMO_ENTITIES),
            mod("torch", "models.demo_scenes").headless_demo_world(DEMO_ENTITIES))


def repoint_models(pkg, world):
    """Every model instance's model to (old + 1) mod 4 through the registry."""
    store = world.modules["renderer"].model_instances
    for e in live(store):
        set_property(pkg, world, e, "model_instance", "model", (int(store.get(e, "model")) + 1) % 4)


@pytest.mark.parametrize("rebuilt", [True, False], ids=["steps rebuilt", "port step kept"])
def test_model_edit_reaches_the_cull_pass(rebuilt):
    """One frame, every model instance re-pointed through the registry in
    both packages, the JAX step rebuilt (its jit bakes the statics in) and
    the port's rebuilt or kept (its eager step reads the statics each
    frame), 3 frames: mi_lod, mi_visible and mi_model equal in every slot on
    every frame, the edit moves LODs, and the view statics equal freshly
    built ones."""
    from lumixengine_tpu_torch.renderer.pipeline import ViewStatics

    (rengine, rworld, _r), (pengine, pworld, _p) = demo_pair()
    rstate, pstate = start_pair(rworld)
    pstep = port_step(pengine, pworld)
    rstate, pstate, trees = step_pair(rengine, rworld, rstate, pengine, pworld, pstate, 1, pstep)
    before = trees[0][1][R + "mi_lod"]
    repoint_models("jax", rworld)
    repoint_models("torch", pworld)
    _rs, _ps, trees = step_pair(rengine, rworld, rstate, pengine, pworld, pstate, FRAMES,
                                None if rebuilt else pstep)
    gaps = [cull_gaps(got, ref) for got, ref in trees]
    print(f"slots that differ from the JAX package's on frames 1-{FRAMES} after the edit "
          f"(of {before.size}): {gaps}")
    assert gaps == [dict.fromkeys(CULL_FIELDS, 0)] * FRAMES
    assert np.count_nonzero(trees[0][1][R + "mi_lod"] != before) > 0
    rm = pworld.modules["renderer"]
    fresh = ViewStatics(rm)
    for f in ("lod_dist2", "material", "mi_model", "radius"):
        np.testing.assert_array_equal(getattr(rm.statics(), f), getattr(fresh, f), err_msg=f)
        np.testing.assert_array_equal(rm.statics().on("cpu").__dict__[f].numpy(),
                                      getattr(fresh, f), err_msg=f)


def test_set_model():
    """set_model on two instances in both packages: the model row and the cull
    radius are the new model's, in the store, the view statics and the
    next frames' cull fields."""
    (rengine, rworld, rsys), (pengine, pworld, psys) = demo_pair()
    rstate, pstate = start_pair(rworld)
    rstate, pstate, _t = step_pair(rengine, rworld, rstate, pengine, pworld, pstate, 1)
    ents = live(pworld.modules["renderer"].model_instances)[:2]
    for world, name in ((rworld, "tree"), (pworld, "tree")):
        for e in ents:
            world.modules["renderer"].set_model(e, name)
    _rs, _ps, trees = step_pair(rengine, rworld, rstate, pengine, pworld, pstate, FRAMES)
    assert [cull_gaps(got, ref) for got, ref in trees] == [dict.fromkeys(CULL_FIELDS, 0)] * FRAMES
    tree_id = psys.models.get_id("tree")
    radius = psys.models.get(tree_id).bounding_radius
    for world in (rworld, pworld):
        rm = world.modules["renderer"]
        for e in ents:
            assert rm.model_instances.get(e, "model") == tree_id
            assert rm.culling.store.get(e, "radius") == np.float32(radius)
    st = pworld.modules["renderer"].statics()
    slots = [pworld.modules["renderer"].model_instances.slot_of(e) for e in ents]
    assert st.mi_model[slots].tolist() == [tree_id] * 2
    np.testing.assert_array_equal(st.radius[slots], np.float32(radius))
    np.testing.assert_array_equal(st.lod_dist2[:, slots],
                                  psys.bake().host_lod_dist2[:, [tree_id] * 2])


# -- the animation statics ------------------------------------------------------------------

def add_stride(pkg, anim):
    """A second locomotion controller (walk → run), so that an animator can
    be re-pointed to another controller."""
    c = mod(pkg, "animation.controller")
    return anim.add_controller(c.Controller(
        "stride", anim.bank_statics,
        c.Blend1D(c.Input(0), [(0.0, c.AnimationNode(1)), (2.0, c.AnimationNode(2))]),
        inputs=["speed"]))


def edit_animation(pkg, world, stride):
    """Each animable's clip to the next of idle, walk, run and its time_scale
    to 0.5, 1.25, ...; every other animator's controller to `stride`,
    through the registry; one animator's speed input through
    set_animator_input. Returns the edited animator."""
    am = world.modules["animation"]
    for i, e in enumerate(live(am.animables)):
        set_property(pkg, world, e, "animable", "clip", (int(am.animables.get(e, "clip")) + 1) % 3)
        set_property(pkg, world, e, "animable", "time_scale", 0.5 + 0.75 * i)
    ators = live(am.animators)
    for e in ators[::2]:
        set_property(pkg, world, e, "animator", "controller", stride)
    am.set_animator_input(ators[1], "speed", 3.7)
    return ators[1]


def with_default_inputs(state, am, as_array):
    """The state with the animators' inputs reset to the module's host
    defaults, as a state built anew would carry them."""
    ms = state.modules["animation"].replace(ctrl_inputs=as_array(am.default_inputs))
    return state.replace(modules={**state.modules, "animation": ms})


def compare_animation(trees):
    errs = {}
    for got, ref in trees:
        for k, atol in (("an_time", CLOCK_ATOL), ("ctrl_clocks", CLOCK_ATOL),
                        ("ctrl_inputs", 0.0), ("pose_pos", POSE_ATOL), ("pose_rot", POSE_ATOL),
                        ("palette", POSE_ATOL)):
            errs[k] = max(errs.get(k, 0.0), float(np.abs(got[A + k] - ref[A + k]).max()))
            np.testing.assert_allclose(got[A + k], ref[A + k], rtol=0, atol=atol, err_msg=k)
    return errs


def test_animation_edits_reach_the_statics():
    """The flagship at test size, one frame, then the animables' clip and
    time_scale, the animators' controller and one input edited in both
    packages, both steps rebuilt: 3 frames of clocks, poses and palettes
    against the JAX package's; the groups read the new clips, time scales
    and controllers."""
    rengine, rworld, _rr, ranim, _rp = mod("jax", "models.demo_scenes").full_frame_world(
        *FLAGSHIP_TEST)
    pengine, pworld, _pr, panim, _pp = mod("torch", "models.demo_scenes").full_frame_world(
        *FLAGSHIP_TEST)
    stride = add_stride("jax", ranim)
    assert add_stride("torch", panim) == stride
    rstate, pstate = start_pair(rworld)
    rstate, pstate, _t = step_pair(rengine, rworld, rstate, pengine, pworld, pstate, 1)
    t0 = ref_to_numpy(rstate)[A + "an_time"]
    ram, pam = rworld.modules["animation"], pworld.modules["animation"]
    edited = edit_animation("jax", rworld, stride)
    assert edit_animation("torch", pworld, stride) == edited
    np.testing.assert_array_equal(pam.default_inputs, ram.default_inputs)
    slot = pam.animators.slot_of(edited)
    assert pam.default_inputs[0, slot] == np.float32(3.7)
    rstate = with_default_inputs(rstate, ram, jnp.asarray)
    pstate = with_default_inputs(pstate, pam, torch.as_tensor)
    _rs, _ps, trees = step_pair(rengine, rworld, rstate, pengine, pworld, pstate, FRAMES)
    print("max abs err", compare_animation(trees))
    st = pam.statics()
    for g in st.an_groups:
        np.testing.assert_array_equal(g["scale"], pam.animables.data["time_scale"][g["cols"]])
        np.testing.assert_array_equal(g["clips"], pam.animables.data["clip"][g["cols"]])
    assert {g["controller"].name for g in st.at_groups} == {"locomotion", "stride"}
    assert sorted(float(s) for g in st.an_groups for s in g["scale"]) == [0.5, 1.25, 2.0, 2.75]
    # the reference took the new time scales: its clocks did not all advance by dt
    assert not np.allclose(trees[0][1][A + "an_time"] - t0, DT)


# -- the animation module's options ---------------------------------------------------------

def crowd(pkg, n=CROWD, seed=5, **module_kw):
    """A skinned crowd of `n` (half animators, half animables) whose
    AnimationModule takes `module_kw`. Returns (engine, world, anim)."""
    ds, am = mod(pkg, "models.demo_scenes"), mod(pkg, "animation.module")
    engine, _renderer, anim = ds.build_engine(with_animation=True, model_instances=n + 8,
                                              animables=n, animators=n)
    anim.create_modules = lambda world: am.AnimationModule(world, anim, max_animables=n,
                                                           max_animators=n, **module_kw)
    world = engine.create_world(capacity=n + 8)
    cam = world.create_entity(position=(0.0, 10.0, 60.0))
    world.create_component(cam, "camera", fov=np.radians(70.0), near=0.3, far=500.0)
    rng = np.random.default_rng(seed)
    for i in range(n):
        e = world.create_entity(position=(rng.uniform(-20, 20), 0.0, rng.uniform(-20, 20)))
        world.create_component(e, "model_instance", model="character")
        if i < n // 2:
            world.create_component(e, "animator", controller="locomotion",
                                   inputs={"speed": float(rng.uniform(0.0, 5.0))})
        else:
            world.create_component(e, "animable", clip=["idle", "walk", "run"][i % 3],
                                   start_time=float(rng.uniform(0, 1)))
    return engine, world, anim


@pytest.mark.parametrize("build_palettes", [True, False])
def test_build_palettes(build_palettes):
    """3 frames of the crowd with the constructor's build_palettes in both
    packages: poses within POSE_ATOL of the JAX package's; the palette built
    (and equal) when on, left as the state had it when off."""
    rengine, rworld, _ra = crowd("jax", build_palettes=build_palettes)
    pengine, pworld, _pa = crowd("torch", build_palettes=build_palettes)
    assert pworld.modules["animation"].build_palettes is build_palettes
    rstate, pstate = start_pair(rworld)
    start = bridge.state_to_numpy(pstate)[A + "palette"]
    _rs, _ps, trees = step_pair(rengine, rworld, rstate, pengine, pworld, pstate, FRAMES)
    compare_animation(trees)
    for got, _ref in trees:
        assert np.array_equal(got[A + "palette"], start) is not build_palettes
    assert not np.array_equal(trees[-1][0][A + "pose_rot"], trees[0][0][A + "pose_rot"])


def test_max_controller_inputs():
    """max_controller_inputs=12 sizes the animators' inputs in both packages;
    an input set through set_animator_input lands in its row and is carried
    by the state over 3 frames."""
    rengine, rworld, _ra = crowd("jax", max_controller_inputs=12)
    pengine, pworld, _pa = crowd("torch", max_controller_inputs=12)
    for world in (rworld, pworld):
        am = world.modules["animation"]
        assert am.default_inputs.shape == (12, CROWD)
        am.set_animator_input(live(am.animators)[0], "speed", 2.25)
    np.testing.assert_array_equal(pworld.modules["animation"].default_inputs,
                                  rworld.modules["animation"].default_inputs)
    rstate, pstate = start_pair(rworld)
    assert tuple(pstate.modules["animation"].ctrl_inputs.shape) == (12, CROWD)
    _rs, _ps, trees = step_pair(rengine, rworld, rstate, pengine, pworld, pstate, FRAMES)
    compare_animation(trees)
    assert trees[-1][0][A + "ctrl_inputs"][0, 0] == np.float32(2.25)


@pytest.mark.parametrize("max_bones, with_renderer", [(64, False), (64, True), (8, True)])
def test_max_bones(max_bones, with_renderer):
    """AnimationSystem(max_bones=...) in both packages: max_bones is the
    argument, or the renderer's widest skeleton where it is wider; the clip
    bank has that many bone rows, equal in both packages."""
    out = {}
    for pkg in PKG:
        ds, am = mod(pkg, "models.demo_scenes"), mod(pkg, "animation.module")
        anim_mod = mod(pkg, "animation.animation")
        engine, renderer = ds.build_engine()
        anim = am.AnimationSystem(engine, renderer=renderer if with_renderer else None,
                                  max_bones=max_bones)
        sk = renderer.models.get(renderer.models.get_id("character")).skeleton
        for i, name in enumerate(("idle", "walk", "run")):
            anim.add_clip(anim_mod.make_walk_clip(sk, name, frames=9 + 4 * i, seed=i))
        table = np.asarray(anim.bank.table)
        out[pkg] = (anim.max_bones, anim.bank_statics.max_bones, table)
    widest = out["torch"][0]
    assert widest == out["jax"][0] == out["jax"][1] == out["torch"][1]
    sk_bones = 0
    if with_renderer:
        _e, renderer = mod("torch", "models.demo_scenes").build_engine()
        sk_bones = renderer.bake().max_bones
    assert widest == max(max_bones, sk_bones)
    assert out["torch"][2].shape[0] == 7 * widest
    np.testing.assert_array_equal(out["torch"][2], out["jax"][2])


# -- the host members -----------------------------------------------------------------------

def test_engine_resources(tmp_path):
    """Engine.resources is a ResourceManagerHub on the engine's file system:
    one file loaded through it, as the JAX package's engine loads it."""
    (tmp_path / "a.txt").write_bytes(b"alpha")
    out = {}
    for pkg in PKG:
        engine = mod(pkg, "engine.engine").Engine(base_path=str(tmp_path))
        res_mod = mod(pkg, "engine.resource")
        assert isinstance(engine.resources, res_mod.ResourceManagerHub)
        assert engine.resources.fs is engine.fs
        res = engine.resources.load("text", "a.txt")
        for _ in range(500):
            engine.fs.process_callbacks()
            if res.state != res_mod.EMPTY:
                break
            time.sleep(0.01)
        out[pkg] = (res.state, res.data, res.refcount, sorted(engine.resources.managers))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == mod("torch", "engine.resource").READY


def host_world(pkg):
    """A root (rotated, scaled) with a child and a grandchild."""
    hm = mod("torch", "core.host_math")
    w = mod(pkg, "engine.world").World(capacity=8, allocator=object())
    root = w.create_entity(position=(1.0, 2.0, 3.0),
                           rotation=hm.quat_from_axis_angle(np.array([0, 1, 0], np.float32), 0.7),
                           scale=(2.0, 2.0, 2.0))
    child = w.create_entity(position=(0.5, -1.0, 0.25))
    w.set_parent(child, root)
    leaf = w.create_entity(position=(0.0, 1.5, 0.0), scale=(0.5, 0.5, 0.5))
    w.set_parent(leaf, child)
    return w, (root, child, leaf)


@pytest.mark.parametrize("setter, value", [
    ("set_rotation", (0.2, -0.3, 0.1, 0.9)), ("set_scale", (3.0, 3.0, 3.0)),
    ("set_position", (-4.0, 0.5, 7.0))])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_world_global_setters(setter, value, which):
    """World.set_rotation, set_scale (and set_position beside them) on a root,
    a child and a grandchild: the stored local transforms and every
    entity's global transform within HOST_ATOL of the JAX package's, and the
    entity's global takes the value."""
    worlds = {}
    for pkg in PKG:
        w, ents = host_world(pkg)
        getattr(w, setter)(ents[which], np.asarray(value, np.float32))
        worlds[pkg] = (w, ents)
    (pw, ents), (rw, _e) = worlds["torch"], worlds["jax"]
    for f in ("local_pos", "local_rot", "local_scale"):
        np.testing.assert_allclose(getattr(pw, f), getattr(rw, f), rtol=0, atol=HOST_ATOL,
                                   err_msg=f)
    for e in ents:
        for got, ref in zip(pw.get_global_transform(e), rw.get_global_transform(e)):
            np.testing.assert_allclose(got, ref, rtol=0, atol=HOST_ATOL)
    pos, rot, scale = pw.get_global_transform(ents[which])
    got = {"set_rotation": rot, "set_scale": scale, "set_position": pos}[setter]
    want = np.asarray(value, np.float32)
    if setter == "set_rotation":
        want = want / np.linalg.norm(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n, batch", [(5, ()), (3, (2,)), (1, (2, 3))])
def test_transform_identity_and_lanes(n, batch):
    rxf, pxf = mod("jax", "core.transform"), mod("torch", "core.transform")
    ref = rxf.Transform.identity(n, batch)
    got = pxf.Transform.identity(n, batch, device="cpu")
    for f in ("pos", "rot", "scale"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
        assert getattr(got, f).dtype == torch.float32
    assert got.lanes == ref.lanes == n
    assert pxf.Transform.identity(n, batch, dtype=torch.float64).pos.dtype == torch.float64


def test_dense_store_mask():
    out = {}
    for pkg in PKG:
        s = mod(pkg, "utils.store").DenseStore(6, {"x": ((), np.float32, 0.0)})
        for e in (10, 11, 12, 13):
            s.add(e, x=float(e))
        s.remove(11)
        s.add(14, x=1.0)
        s.remove(13)
        out[pkg] = s.mask()
    np.testing.assert_array_equal(out["torch"], out["jax"])
    assert out["torch"].dtype == bool and int(out["torch"].sum()) == 3


def test_draw_stream_clear():
    out = {}
    for pkg in PKG:
        ds = mod(pkg, "renderer.draw_stream").DrawStream()
        ds.push("set_pass", name="main")
        ds.substream("shadows").push("draw", n=3)
        ds.clear()
        ds.push("draw", n=1)

        class Backend:
            calls = []

            def draw(self, **kw):
                self.calls.append(kw)

        b = Backend()
        out[pkg] = (ds.replay(b), b.calls, len(ds.commands))
    assert out["torch"] == out["jax"] == (1, [{"n": 1}], 1)


def test_model_mesh_id_and_fields():
    rmodel, pmodel = mod("jax", "renderer.model"), mod("torch", "renderer.model")
    assert pmodel.Model("m").mesh_id == rmodel.Model("m").mesh_id == 0
    assert pmodel.Model("m", mesh_id=3).mesh_id == 3
    assert ({f.name for f in dataclasses.fields(pmodel.Model)}
            == {f.name for f in dataclasses.fields(rmodel.Model)})


def walk_clips(pkg):
    _e, _r, anim = mod(pkg, "models.demo_scenes").build_engine(with_animation=True)
    return anim.clips


def test_clip_registry_get():
    rclips, pclips = walk_clips("jax"), walk_clips("torch")
    for name in ("idle", "walk", "run"):
        cid = pclips.get_id(name)
        assert cid == rclips.get_id(name)
        got, ref = pclips.get(cid), rclips.get(cid)
        assert got is pclips.clips[cid] and got.name == ref.name == name
        np.testing.assert_array_equal(got.pos, ref.pos)
        np.testing.assert_array_equal(got.rot, ref.rot)
    with pytest.raises(IndexError):
        pclips.get(len(pclips.clips))


@pytest.mark.parametrize("looping", [True, False])
@pytest.mark.parametrize("clip", ["idle", "walk", "run"])
def test_clip_sample_host(clip, looping):
    """The host oracle at times before, inside, at the end of and past the
    clip, against the JAX package's within HOST_ATOL."""
    rc, pc = walk_clips("jax"), walk_clips("torch")
    rclip, pclip = rc.get(rc.get_id(clip)), pc.get(pc.get_id(clip))
    length = pclip.length_seconds
    for t in (-0.3, 0.0, 0.1234, 0.5 * length, length - 1e-4, length, 1.7 * length + 0.01):
        for got, ref in zip(pclip.sample_host(t, looping), rclip.sample_host(t, looping)):
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=HOST_ATOL)
