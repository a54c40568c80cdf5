"""Loading worlds through the port's host tier (importers/instantiate.py,
app.Runner.load_world, the scripts' asset bank and world:load, navigation's
shipped navmeshes, the per-phase cost model) against the JAX package on the
CPU, on inputs the test builds: scene dicts (tests/test_torch_unv.py's and
models/host_scenes.py's), `.unv` files written by ``write_unv`` and `.nav`
blobs packed with ``struct``.

``instantiate_scene`` gives equal worlds in both packages (the entity map,
the report's counters, the host arrays, every module's component records
and the device state through ``bridge``, bit for bit), then 3 Runner ticks
of each agree within the step harness's tolerances (tests/test_torch_step.py:
transforms TRANSFORM_ATOL, bodies BODY_POS_ATOL/BODY_VEL_ATOL, cull masks
outside the margins, animation at its atols; navigation NAV_ATOL; every other
field bit for bit). The placeholder skeletons and clips are seeded with
Python's ``hash`` of their paths in both packages, so the two agree only
within one process, as here."""
import importlib
import os
from collections import Counter

import numpy as np
import pytest
import torch

from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.models import host_scenes as H
from test_torch_bridge import ref_to_numpy
from test_torch_step import R, assert_rest_equal, compare, compare_arms
from test_torch_unv import deep_eq, full_scene

torch.set_num_threads(2)

PKG = {"jax": "lumixengine_tpu", "torch": "lumixengine_tpu_torch"}
NAV_ATOL = 2e-4        # tests/test_torch_nav_gui_audio.py: sqrt/rsqrt ulps over the agents
SCRIPT_ATOL = 1e-5     # the fast path's rows: sin/cos ulps
DT = 1.0 / 60.0


def mod(pkg, name):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


def instantiate(pkg, scene, data_dirs):
    inst = mod(pkg, "importers.instantiate")
    if pkg == "jax":
        return inst.instantiate_scene(scene, data_dirs=data_dirs)
    return inst.instantiate_scene(scene, data_dirs=data_dirs, device="cpu")


def state_of(pkg, world):
    return (ref_to_numpy(world.device_state()) if pkg == "jax"
            else bridge.state_to_numpy(world.device_state("cpu")))


def assert_instances_equal(rinst, pinst):
    assert pinst.emap == rinst.emap
    assert Counter(pinst.report) == Counter(rinst.report)
    rw, pw = rinst.world, pinst.world
    for name in ("alive", "parent", "local_pos", "local_rot", "local_scale", "partition_of"):
        np.testing.assert_array_equal(getattr(pw, name), getattr(rw, name), err_msg=name)
    assert pw.names == rw.names and pw.partitions == rw.partitions
    assert list(pw.modules) == list(rw.modules)
    rser, pser = mod("jax", "engine.serialize"), mod("torch", "engine.serialize")
    for name, rm in rw.modules.items():
        assert pser._dump_module_components(pw.modules[name]) == \
            rser._dump_module_components(rm), name
    ref, got = state_of("jax", rw), state_of("torch", pw)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.fixture
def data_dir(tmp_path):
    d = str(tmp_path / "data")
    H.write_stress_nav(d)
    return d


@pytest.mark.parametrize("name", ["stress", "full"])
def test_instantiate_scene_gives_equal_worlds(name, data_dir):
    scene = (H.stress_scene(entities=300, bodies=16, agents=8) if name == "stress"
             else full_scene())
    rinst = instantiate("jax", scene, (data_dir,))
    pinst = instantiate("torch", scene, (data_dir,))
    assert_instances_equal(rinst, pinst)
    assert pinst.report["entities"] == len(scene["entities"])
    if name == "stress":
        zone = pinst.world.modules["navigation"].zone
        assert zone.from_navmesh and 0 < zone.walkable.mean() < 1
        np.testing.assert_array_equal(zone.walkable,
                                      rinst.world.modules["navigation"].zone.walkable)


def _runner(pkg, scene, data_dir):
    inst = instantiate(pkg, scene, (data_dir,))
    runner = mod(pkg, "app").Runner([], engine=inst.engine)
    runner.use_world(inst.world)
    runner.start()
    return runner


def compare_frame(pworld, pstate, got, ref, errs):
    """The step harness's checks, then navigation within NAV_ATOL, the
    scripts' fast-path rows within SCRIPT_ATOL and every other field equal."""
    flips = compare(pworld, pstate, got, ref, errs)
    checked = compare_arms(got, ref, errs)
    for k in sorted(got):
        if k.startswith(("modules.navigation.agent_pos", "modules.navigation.agent_vel")):
            atol = NAV_ATOL
        elif k.startswith("modules.script.") and got[k].dtype.kind == "f":
            atol = SCRIPT_ATOL
        else:
            continue
        checked.add(k)
        errs[k] = max(errs.get(k, 0.0), float(np.abs(got[k] - ref[k]).max(initial=0.0)))
        np.testing.assert_allclose(got[k], ref[k], atol=atol, rtol=0, err_msg=k)
    assert_rest_equal(got, ref, checked | {R + m for m in ("mi_visible", "mi_lod", "pl_visible")}
                      | {R + "counters.visible_count", R + "counters.lights_visible"})
    return flips


def test_instantiated_scene_three_ticks_match_reference(data_dir):
    """The stress scene at test size loaded in both packages and started
    through the Runner (the spawner's createEntityEx runs in start()), then
    3 ticks: the port's state against the reference's each tick."""
    scene = H.stress_scene(entities=300, bodies=16, agents=8)
    rr, pr = _runner("jax", scene, data_dir), _runner("torch", scene, data_dir)
    assert pr.world.entity_count == rr.world.entity_count > 300
    np.testing.assert_array_equal(pr.world.alive, rr.world.alive)
    errs, flips = {}, []
    for _ in range(3):
        rr.tick()
        pr.tick()
        got, ref = bridge.state_to_numpy(pr.state), ref_to_numpy(rr.state)
        assert set(got) == set(ref)
        flips.append(compare_frame(pr.world, pr.state, got, ref, errs))
    print("boundary flips", flips, "max abs err", {k: v for k, v in errs.items() if v > 0})
    assert int(got["frame"]) == 3
    assert len(pr.world.modules["renderer"].model_instances) == len(
        rr.world.modules["renderer"].model_instances)


# -- the JAX package's tests that read no reference data, as parity cases --------------


def _signal_scene(with_script):
    scene = {"version": 1, "entities": [{"entity": 0, "pos": (0, 0, 0), "rot": (0, 0, 0, 1),
                                         "scale": (1, 1, 1)}],
             "names": {0: "button" if with_script else "sig_holder"}, "hierarchy": [],
             "core": {"signals": [{"entity": 0, "event_module": "gui", "event": "buttonClicked",
                                   "function_module": "lua_script", "function": "call"}],
                      "splines": []}}
    if with_script:
        scene["lua_script"] = {"scripts": [], "inline_scripts": [
            {"entity": 0, "source": "fired = 0\nfunction onSignal() fired = fired + 1 end"}]}
    return scene


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_core_signals_instantiate(pkg):
    inst = instantiate(pkg, _signal_scene(False), ())
    assert inst.report["signal"] == 1
    sig = inst.world.modules["core"].signals[inst.emap[0]]
    assert sig["event_component"] == "gui" and sig["event"] == "buttonClicked"
    assert sig["function_component"] == "script" and sig["function"] == "call"


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_imported_signal_dispatches(pkg):
    inst = instantiate(pkg, _signal_scene(True), ())
    cm = inst.world.modules["core"]
    e = inst.emap[0]
    assert cm.signals[e]["function_component"] == "script"
    assert cm.dispatch_signals([{"module": "gui", "event": "buttonClicked", "entity": e}]) == 1
    env = inst.world.modules["script"].lua_envs[e][0]
    assert float(env.env.get("fired")) == 1.0
    assert cm.dispatch_signals([{"module": "gui", "event": "rectHovered", "entity": e}]) == 0


def _export_live(pkg):
    reflection = mod(pkg, "engine.reflection")
    reflection.register_builtin_components()
    scene = H.empty_scene(("renderer",))
    scene["version"] = 1
    cam, light = H.add_entity(scene, (0, 0, 0), name="cam"), H.add_entity(scene, (1, 0, 0),
                                                                            name="light")
    H.camera(scene, cam, fov=1.0, far=100.0)
    H.point_light(scene, light, (1.0, 1.0, 1.0), 2.0, 5.0, guid=7)
    inst = instantiate(pkg, scene, ())
    w = inst.world
    cam_e, light_e = inst.emap[0], inst.emap[1]
    reflection.registry.set_property(w, cam_e, "camera", "fov", 0.7)
    reflection.registry.set_property(w, cam_e, "camera", "is_ortho", True)
    reflection.registry.set_property(w, cam_e, "camera", "ortho_size", 25.0)
    reflection.registry.set_property(w, light_e, "point_light", "intensity", 9.0)
    out = mod(pkg, "importers.instantiate").export_scene(inst)
    e2 = w.create_entity(name="cam2")
    w.create_component(e2, "camera", fov=0.5, near=1.0, far=10.0, ortho_size=3.0, is_ortho=True)
    e3 = w.create_entity(name="light2")
    w.create_component(e3, "point_light", intensity=1.0, range=2.0)
    return out, mod(pkg, "importers.instantiate").export_scene(inst)


def test_export_writes_back_live_properties():
    (rout, rout2), (pout, pout2) = _export_live("jax"), _export_live("torch")
    deep_eq(pout, rout)
    deep_eq(pout2, rout2)
    cam = pout["renderer"]["cameras"][0]
    assert abs(cam["fov"] - 0.7) < 1e-6 and cam["is_ortho"] is True
    assert abs(cam["ortho_size"] - 25.0) < 1e-6
    pl = pout["renderer"]["point_lights"][0]
    assert abs(pl["intensity"] - 9.0) < 1e-6 and pl["guid"] == 7
    new_cam = [c for c in pout2["renderer"]["cameras"] if c["entity"] != 0][0]
    assert new_cam["is_ortho"] is True and abs(new_cam["ortho_size"] - 3.0) < 1e-6
    assert [p for p in pout2["renderer"]["point_lights"] if p["entity"] != 1][0]["guid"] > 7


def test_export_and_save_world_unv_after_edits(data_dir, tmp_path):
    """Edit the instantiated stress scene (move, rename, destroy, reparent,
    a new entity with a body), export and save it in both packages: equal
    scene dicts and equal .unv bytes, and the saved file loads again."""
    from lumixengine_tpu.importers import unv as runv

    scene = H.stress_scene(entities=200, bodies=8, agents=4)
    outs = {}
    for pkg in ("jax", "torch"):
        inst = instantiate(pkg, scene, (data_dir,))
        w = inst.world
        w.set_local_transform(inst.emap[5], position=(3.0, 4.0, 5.0))
        w.names[inst.emap[6]] = "renamed"
        w.set_parent(inst.emap[8], inst.emap[150])
        e = w.create_entity(position=(0.0, 9.0, 0.0), name="new_body")
        w.create_component(e, "rigid_actor", motion="dynamic", shape="sphere", radius=0.25)
        w.create_component(e, "model_instance", model=inst.assets.model_id("models/cube.fbx"))
        w.destroy_entity(inst.emap[7])     # after the new entity: its slot is not reused
        path = str(tmp_path / f"{pkg}.unv")
        mod(pkg, "importers.instantiate").save_world_unv(inst, path)
        outs[pkg] = (mod(pkg, "importers.instantiate").export_scene(inst),
                     open(path, "rb").read())
    deep_eq(outs["torch"][0], outs["jax"][0])
    assert outs["torch"][1] == outs["jax"][1]
    assert outs["torch"][0]["_export_new_entities"] == 1
    again = mod("torch", "importers.unv").parse_unv(outs["torch"][1])
    deep_eq(again, runv.parse_unv(outs["jax"][1]))
    assert len(again["entities"]) == len(scene["entities"])   # one destroyed, one new


def _level_scene():
    sc = H.stress_scene(entities=120, bodies=6, agents=4, scripts=2)
    return sc


MENU_LUA = """
loaded = 0
function onInputEvent(event)
    if event.type == "button" and event.down and loaded == 0 then
        local p = this.world:createPartition("level")
        this.world:setActivePartition(p)
        this.world:load("maps/level.unv", function() loaded = 1 end)
    end
end
"""


def _menu_files(tmp_path):
    """maps/menu.unv (a rect, and a script that loads maps/level.unv into
    a new partition on any key) and maps/level.unv, written by the port."""
    from lumixengine_tpu_torch.importers.unv_write import save_unv

    d = str(tmp_path / "data")
    H.write_stress_nav(d)
    os.makedirs(os.path.join(d, "maps"), exist_ok=True)
    menu = H.empty_scene()
    cam = H.add_entity(menu, (0.0, 2.0, 10.0), name="camera")
    H.camera(menu, cam)
    e = H.add_entity(menu, (0.0, 0.0, 0.0), name="menu")
    H.gui_rect(menu, e, (0.3, 0.4, 0.7, 0.6), text="press any key")
    menu["lua_script"]["inline_scripts"].append({"entity": e, "source": MENU_LUA})
    save_unv(menu, os.path.join(d, "maps", "menu.unv"))
    save_unv(_level_scene(), os.path.join(d, "maps", "level.unv"))
    return d


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_main_menu_loads_a_level_on_keypress(pkg, tmp_path):
    """tests/test_world_streaming.py's main-menu flow on a .unv the test
    writes: a key press runs the script's world:load, the level's entities
    land in a new partition, the Runner rebuilds the step and its bodies
    fall."""
    d = _menu_files(tmp_path)
    inst = mod(pkg, "importers.instantiate").load_world(
        os.path.join(d, "maps", "menu.unv"), data_dirs=(d,),
        **({} if pkg == "jax" else {"device": "cpu"}))
    runner = mod(pkg, "app").Runner([], engine=inst.engine)
    runner.use_world(inst.world)
    runner.start()
    runner.run(2)
    world = inst.world
    n0 = world.entity_count
    assert len(world.modules["renderer"].model_instances) == 0
    inst.engine.input.inject_button(mod(pkg, "engine.input").DEVICE_KEYBOARD, 65, True)
    runner.tick(1 / 30)
    runner.tick(1 / 30)
    assert world.entity_count >= n0 + 120
    assert "level" in world.partitions
    level = world.partitions.index("level")
    assert int((world.partition_of[:world.capacity][world.alive] == level).sum()) >= 120
    assert len(world.modules["physics"].actors) == 7
    assert np.asarray(runner.state.world.pos).shape[-1] >= n0 + 120
    env = world.modules["script"].lua_envs[inst.emap[1]][0]
    assert float(env.env.get("loaded")) == 1.0
    pm = world.modules["physics"]
    y0 = [world.get_global_transform(e)[0][1] for e in list(pm.actors._slot_of)[1:]]
    runner.run(10)
    slots = world.to_slots(np.asarray(list(pm.actors._slot_of)[1:]))
    y1 = np.asarray(runner.state.world.pos)[1, slots]
    assert (y1 < np.asarray(y0)).all()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_instantiate_additive_capacity_guard(pkg, tmp_path):
    d = _menu_files(tmp_path)
    engine, _renderer = mod(pkg, "models.demo_scenes").build_engine(model_instances=8)
    world = engine.create_world(capacity=4)
    world.create_entity(name="only")
    with pytest.raises(RuntimeError, match="free slots"):
        mod(pkg, "importers.instantiate").instantiate_additive(
            engine, world, os.path.join(d, "maps", "level.unv"), data_dirs=(d,))


# -- the repaired asset bank, and what still raises ------------------------------------

SPAWN_LUA = """
function start()
    this.world:createEntityEx({
        position = {1, 2, 3},
        name = "spawned",
        model_instance = { source = "models/x.fbx" }
    })
end
"""


def _spawn_world(pkg):
    app = mod(pkg, "app")
    engine = (app.create_full_engine(model_instances=8) if pkg == "jax"
              else app.create_full_engine(device="cpu", model_instances=8))
    world = engine.create_world(capacity=16)
    cam = world.create_entity(position=(0, 2, 10), name="camera")
    world.create_component(cam, "camera")
    e = world.create_entity(name="spawner")
    world.modules["script"].attach_lua_script(e, source=SPAWN_LUA)
    runner = app.Runner([], engine=engine)
    runner.use_world(world)
    runner.start()
    runner.run(2)
    return runner


def test_lua_create_entity_ex_with_a_model_instance_matches_reference():
    """The Lua createEntityEx path asks the script module's asset bank for
    the model (≙ the reference's lazily built SceneAssets); before the
    repair the port raised NotImplementedError there."""
    rr, pr = _spawn_world("jax"), _spawn_world("torch")
    rw, pw = rr.world, pr.world
    e = pw.find_by_name("spawned")
    assert e == rw.find_by_name("spawned") >= 0
    assert e in pw.modules["renderer"].model_instances
    rser, pser = mod("jax", "engine.serialize"), mod("torch", "engine.serialize")
    for name in ("renderer", "script"):
        assert pser._dump_module_components(pw.modules[name]) == \
            rser._dump_module_components(rw.modules[name]), name
    for name in ("alive", "parent", "local_pos", "local_rot", "local_scale"):
        np.testing.assert_array_equal(getattr(pw, name), getattr(rw, name), err_msg=name)
    assert pr.world.modules["script"].asset_bank().report["model_placeholder"] == 1
    got, ref = bridge.state_to_numpy(pr.state), ref_to_numpy(rr.state)
    for k in ("alive", "parent", R + "mi_entity", R + "mi_model", "local.pos"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_an_fbx_file_that_exists_raises_naming_the_roadmap_item(tmp_path):
    """An FBX file the data dirs hold is decoded, in the port as in the
    reference (the name dates from before the port had the codec, when such
    a file raised): a file that is the FBX magic alone does not parse and
    becomes the placeholder, as a model instance's model and as the clips of
    a controller's entries; a written FBX is a real model. Both packages
    give equal worlds."""
    from lumixengine_tpu_torch.models import asset_scenes as A

    d = tmp_path / "data"
    (d / "models").mkdir(parents=True)
    (d / "models" / "hero.fbx").write_bytes(b"Kaydara FBX Binary  \0")
    (d / "models" / "box.fbx").write_bytes(A.box_fbx(0))
    (d / "anims").mkdir()
    (d / "anims" / "hero.act").write_bytes(A.act_bytes("models/hero.fbx", ".ani:models/hero.fbx"))
    scene = H.empty_scene(("renderer", "animation"))
    e = H.add_entity(scene, (0, 0, 0))
    H.model_instance(scene, e, "models/hero.fbx")
    H.model_instance(scene, H.add_entity(scene, (2, 0, 0)), "models/box.fbx")
    scene["animation"]["animators"].append({"default_set": 0, "entity": e, "flags": 0,
                                            "controller": "anims/hero.act"})
    rinst, pinst = instantiate("jax", scene, (str(d),)), instantiate("torch", scene, (str(d),))
    assert_instances_equal(rinst, pinst)
    rep = pinst.report
    assert (rep["model_placeholder"], rep["model_fbx"]) == (1, 1)
    assert (rep["controller_act"], rep["clip_placeholder"], rep["clip_fbx"]) == (1, 1, 0)
    models = pinst.world.modules["renderer"].system.models
    assert models.get(models.get_id("models/box.fbx")).vertex_triangles.shape == (12, 3)


# -- the Runner: load_world, app.main --world, phase_metrics ---------------------------


def test_runner_loads_a_blob_and_a_unv(tmp_path, data_dir):
    from lumixengine_tpu_torch import app
    from lumixengine_tpu_torch.engine import serialize
    from lumixengine_tpu_torch.importers.unv_write import save_unv

    path = str(tmp_path / "w.unv")
    save_unv(H.stress_scene(entities=150, bodies=4, agents=4, scripts=2), path)
    runner = app.Runner([], engine=app.create_full_engine(base_path=data_dir, device="cpu"))
    runner.load_world(path)
    assert runner.world.entity_count == 150 and runner.engine.device.type == "cpu"
    assert runner.world.modules["navigation"].zone.from_navmesh
    runner.start()
    runner.run(3)
    # a blob names the engine's model and clip ids: it loads into the engine it came from
    blob = serialize.serialize_world(runner.world)
    with open(os.path.join(data_dir, "w.world"), "wb") as f:
        f.write(blob)
    for source in (blob, "w.world"):
        r2 = app.Runner([], engine=runner.engine)
        r2.load_world(source)
        assert r2.world.entity_count == runner.world.entity_count
        np.testing.assert_array_equal(r2.world.local_pos, runner.world.local_pos)
        r2.start()
        r2.run(1)
    assert app.main(["--world", path, "--frames", "2", "--device", "cpu"]) == 0


def test_phase_metrics_keys_and_fractions():
    """tests/test_app.py's phase test on the port: every overridden module
    phase and world.propagate carry a fraction, the fractions sum to 1, the
    est_ms keys split the measured frame time, the counters reach the
    profiler, and a second call reuses the profile."""
    from lumixengine_tpu_torch import app
    from lumixengine_tpu_torch.core import profiler

    engine = app.create_full_engine(device="cpu", model_instances=64)
    runner = app.Runner([], engine=engine)
    world = engine.create_world(capacity=64)
    cam = world.create_entity(position=(0, 2, 10), name="camera")
    world.create_component(cam, "camera")
    e = world.create_entity(position=(0, 5, 0))
    world.create_component(e, "rigid_actor", motion="dynamic", shape="sphere", radius=0.5)
    runner.use_world(world)
    runner.start()
    runner.run(4)
    m = runner.metrics(phases=True)
    fracs = {k: v for k, v in m.items() if k.startswith("phase.") and k.endswith(".frac")}
    assert "phase.physics.update_parallel.frac" in fracs
    assert "phase.world.propagate.frac" in fracs and "phase.extra.cull.frac" in fracs
    assert abs(sum(fracs.values()) - 1.0) < 1e-2, fracs
    ms_keys = [k for k in m if k.startswith("phase.") and k.endswith(".est_ms")]
    assert ms_keys and "frame_ms" in m
    assert abs(sum(m[k] for k in ms_keys) - m["frame_ms"]) < 0.05 * m["frame_ms"] + 1e-3
    assert profiler.counters(ms_keys[0])
    profile = runner._phase_profile
    assert profile["physics.update_parallel"]["bytes"] > 0
    assert runner.metrics(phases=True).keys() == m.keys() and runner._phase_profile is profile
    # the reference's key set on the same world
    from lumixengine_tpu import app as rapp

    rengine = rapp.create_full_engine(model_instances=64)
    rrunner = rapp.Runner([], engine=rengine)
    rworld = rengine.create_world(capacity=64)
    c = rworld.create_entity(position=(0, 2, 10), name="camera")
    rworld.create_component(c, "camera")
    b = rworld.create_entity(position=(0, 5, 0))
    rworld.create_component(b, "rigid_actor", motion="dynamic", shape="sphere", radius=0.5)
    rrunner.use_world(rworld)
    rrunner.start()
    rrunner.run(2)
    rkeys = {k for k in rrunner.metrics() if k.startswith("phase.") and k.endswith(".frac")}
    assert set(fracs) == rkeys
