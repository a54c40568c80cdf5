"""The editor's host views in the port against the JAX package, on the CPU:

* ``SceneView``: the paused frame's dt = 0 step (the cull pass, and the
  physics solve on a world with bodies) and a playing frame, both held to
  the step harness's tolerances (tests/test_torch_instantiate.py's
  ``compare_frame``: transforms TRANSFORM_ATOL, bodies BODY_POS_ATOL and
  BODY_VEL_ATOL, cull masks outside their margins, every other field bit
  for bit); the presented images within SOFT_LEVELS u8 levels of the JAX
  package's (the software present's limit, tests/test_torch_postprocess.py);
  the fly keys; a terrain sculpt showing on the very next frame;
* ``PhysicsView``: joint rows and gizmo segments equal, a layer edit
  followed by one step (the new filter reaches the solve: the pair's
  contacts go inactive) within the step tolerances;
* ``ProfilerUI`` on a fixed clock: flame rows and screens equal;
* ``AssetBrowser``, ``MaterialEditor`` and ``MetaEditor`` on the files
  ``models/asset_scenes.py`` writes (with a ``.pat``, a ``.unv``, a
  ``.wav`` and a prefab beside them): entries, details, edits, saved files
  and screens equal, and the editor app's '2', '@' and '9' flows over them.
"""
import importlib
import os
import re
import shutil
import types

import numpy as np
import pytest
import torch

from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.models import asset_scenes as AS
from lumixengine_tpu_torch.models import host_scenes as H
from test_torch_bridge import ref_to_numpy, use_fused_solver
from test_torch_instantiate import compare_frame
from test_torch_step import BODY_POS_ATOL, BODY_VEL_ATOL

torch.set_num_threads(2)

PKG = {"jax": "lumixengine_tpu", "torch": "lumixengine_tpu_torch"}
SOFT_LEVELS = 2         # u8 levels: the software present against the JAX backend
UP, DOWN, LEFT, RIGHT, ENTER, ESC = 0x26, 0x28, 0x25, 0x27, 13, 27
PLAY_FRAMES = 45        # the stress scene's bodies land by frame ~35


def mod(pkg, name):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


def keys(obj, *seq):
    for k in seq:
        if isinstance(k, int):
            obj.handle_key(k)
        else:
            for ch in k:
                obj.handle_key(0, ch)


def assert_images_close(got, ref, label=""):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32)).max()
    print(label, "image max u8 diff", int(diff))
    assert diff <= SOFT_LEVELS, (label, int(diff))


def states(views):
    """(port runner state as numpy, JAX runner state as numpy)."""
    return (bridge.state_to_numpy(views["torch"].runner().state),
            ref_to_numpy(views["jax"].runner().state))


# -- the scene view -----------------------------------------------------------------------

def stress_views(tmp_path, entities=300, bodies=16):
    """The scene view over the stress scene in each package."""
    data_dir = str(tmp_path / "data")
    H.write_stress_nav(data_dir)
    scene = H.stress_scene(entities=entities, bodies=bodies, agents=8)
    views = {}
    for pkg in ("jax", "torch"):
        inst = mod(pkg, "importers.instantiate")
        kw = {"device": "cpu"} if pkg == "torch" else {}
        sc = inst.instantiate_scene(scene, data_dirs=(data_dir,), **kw)
        views[pkg] = mod(pkg, "editor.scene_view").SceneView(sc.engine, sc.world,
                                                             width=64, height=36)
    return views


def test_scene_view_frames_on_a_world_with_bodies_match_reference(tmp_path, monkeypatch):
    """The stress scene at test size (the pruned branch, 16 bodies): the
    paused frame, the fly keys and the dt = 0 step, then PLAY_FRAMES
    playing frames (the bodies land: the solve on active contacts)."""
    views = stress_views(tmp_path)
    assert views["torch"].cam != views["torch"].world.modules["renderer"].active_camera
    errs, frames = {}, []
    imgs = {pkg: v.frame() for pkg, v in views.items()}
    assert_images_close(imgs["torch"], imgs["jax"], "paused")
    got, ref = states(views)          # the Runner's first snapshot
    assert int(got["frame"]) == int(ref["frame"]) == 0
    pworld = views["torch"].world
    compare_frame(pworld, views["torch"].runner().state, got, ref, errs)
    for pkg, v in views.items():
        keys(v, "w", "w", "a", LEFT, UP, "e")
        assert v._dirty
        frames.append(v.frame())      # re-uploads, steps at dt = 0
        assert not v._dirty
    assert_images_close(frames[1], frames[0], "flown")
    got, ref = states(views)
    assert int(got["frame"]) == int(ref["frame"]) == 1
    np.testing.assert_array_equal(got["time"], ref["time"])
    compare_frame(pworld, views["torch"].runner().state, got, ref, errs)
    np.testing.assert_array_equal(views["torch"].cam_pos, views["jax"].cam_pos)
    # play on the reference's fused solve (in interpret mode), the semantics
    # K2 ports; its dt = 0 step above ran the jnp solve, which masks the
    # empty contact slots' 0 / 0 bias (the fused one gives NaN there)
    use_fused_solver(monkeypatch, views["jax"].world)
    views["jax"].runner()._rebuild_after_structure_change(())
    for i in range(PLAY_FRAMES):
        imgs = {}
        for pkg, v in views.items():
            if not v.playing:
                keys(v, "g")
            imgs[pkg] = v.frame()
        if i % 10 == 0 or i == PLAY_FRAMES - 1:
            assert_images_close(imgs["torch"], imgs["jax"], "playing")
            got, ref = states(views)
            compare_frame(pworld, views["torch"].runner().state, got, ref, errs)
    assert int(got["frame"]) == int(ref["frame"]) >= PLAY_FRAMES
    assert got["modules.physics.counters.active_contacts"].sum() > 0
    text = {pkg: v.render_text(60, 12) for pkg, v in views.items()}
    assert "scene view" in text["torch"] and "\x1b[38;2;" in text["torch"]
    print("scene view max abs err", {k: v for k, v in errs.items() if v > 0})


def test_paused_step_on_resting_contacts_is_finite():
    """The port's dt = 0 step on a world whose host state holds active,
    penetrating contacts (box 0 sunk 1 cm into the slab): finite, and no
    velocity comes of it (the Baumgarte bias is 0 at dt = 0; the reference's
    is inf · depth, NaN in the solve)."""
    engine, world, phys = layer_world("torch")
    world.set_local_transform(world.find_by_name("box0"), position=(0.0, 0.49, 0.0))
    sv = mod("torch", "editor.scene_view").SceneView(engine, world, width=32, height=18)
    sv.frame()
    keys(sv, "w")
    sv.frame()
    st = bridge.state_to_numpy(sv.runner().state)
    assert int(st["frame"]) == 1
    assert st["modules.physics.counters.active_contacts"].sum() > 0
    for k, v in st.items():
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), k
    np.testing.assert_array_equal(st["modules.physics.vel"], 0.0)
    np.testing.assert_array_equal(st["modules.physics.angvel"], 0.0)


def test_scene_view_on_the_demo_world_equal_screens():
    """headless_demo_world(128), a world with room for the editor camera:
    the ANSI screens equal string for string, paused and after flying."""
    views = {}
    for pkg in ("jax", "torch"):
        engine, world, _ = mod(pkg, "models.demo_scenes").headless_demo_world(num_entities=128)
        if pkg == "torch":
            engine.device = torch.device("cpu")
        world2 = world
        views[pkg] = mod(pkg, "editor.scene_view").SceneView(engine, world2, width=64, height=36)
    for script in ((), ("w", "d", RIGHT, DOWN), ("+", "w", "c")):
        text = {}
        for pkg, v in views.items():
            keys(v, *script)
            text[pkg] = v.render_text(70, 20)
        assert text["torch"] == text["jax"], script
    assert views["torch"].status == views["jax"].status


def terrain_views(pkgs=("jax", "torch"), pad=4):
    """tests/test_torch_postprocess.py's terrain (a seeded 65 x 65 field,
    y scale 6) with its point light. `pad` empty entities come first, so
    that the editor camera's entity id is not below the camera store's
    capacity (4): the reference passes that id as a camera slot."""
    views = {}
    for pkg in pkgs:
        engine, renderer = mod(pkg, "models.demo_scenes").build_engine(model_instances=8)
        if pkg == "torch":
            engine.device = torch.device("cpu")
        rng = np.random.default_rng(0)
        tid = renderer.terrains.add(rng.uniform(0, 1, (65, 65)).astype(np.float32),
                                    xz_scale=1.0, y_scale=6.0)
        world = engine.create_world(capacity=16)
        for _ in range(pad):
            world.create_entity(name="pad")
        t = world.create_entity(position=(-32.0, -4.0, -20.0), name="terrain")
        world.create_component(t, "terrain", terrain=tid)
        lamp = world.create_entity(position=(0.0, 6.0, 14.0))
        world.create_component(lamp, "point_light", color=(1.0, 0.9, 0.8), intensity=50.0,
                               range=40.0)
        sv = mod(pkg, "editor.scene_view").SceneView(engine, world, width=48, height=28)
        views[pkg] = (sv, renderer, tid)
    return views


def test_scene_view_sculpt_shows_on_the_next_frame():
    views = terrain_views()
    before, after, heights, heights0 = {}, {}, {}, {}
    for pkg, (sv, renderer, tid) in views.items():
        heights0[pkg] = renderer.terrains.get(tid)["heights"].copy()
        sv.pitch = -0.6
        sv._apply_camera()
        before[pkg] = sv.frame()
        keys(sv, "]", "t", "t")
        heights[pkg] = renderer.terrains.get(tid)["heights"].copy()
        after[pkg] = sv.frame()
    np.testing.assert_array_equal(heights["torch"], heights["jax"])
    assert (heights["torch"] - heights0["torch"]).max() > 0.3
    assert_images_close(before["torch"], before["jax"], "before sculpt")
    assert_images_close(after["torch"], after["jax"], "after sculpt")
    changed = np.abs(after["torch"].astype(np.int32) - before["torch"].astype(np.int32)).max(-1)
    assert np.count_nonzero(changed) > 20        # the very next frame shows the bump
    for pkg, (sv, renderer, tid) in views.items():
        keys(sv, "T", "T")
        np.testing.assert_allclose(renderer.terrains.get(tid)["heights"], heights0[pkg],
                                   rtol=0, atol=1e-5)
        assert "sculpt" in sv.status
    assert views["torch"][0].status == views["jax"][0].status


def test_scene_view_renders_from_the_editor_camera_in_a_small_world():
    """The port's scene view passes its camera's store slot: with the
    editor camera's entity id below the store's capacity the frame is
    still taken from that camera."""
    sv, _r, _t = terrain_views(("torch",), pad=0)["torch"]
    assert sv.cam < 4
    img = sv.frame()
    be = sv.runner()._present_backend
    np.testing.assert_allclose(be.cam_pos, sv.cam_pos, atol=1e-5)
    assert be.fov == pytest.approx(1.1)
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 10


def test_scene_view_camera_falls_back_on_a_full_world():
    """World at capacity: the view flies the game camera, in both packages."""
    for pkg in ("jax", "torch"):
        engine, world, _ = mod(pkg, "models.demo_scenes").headless_demo_world(num_entities=64)
        if pkg == "torch":
            engine.device = torch.device("cpu")
        while world.entity_count < world.capacity:
            world.create_entity()
        sv = mod(pkg, "editor.scene_view").SceneView(engine, world, width=32, height=18)
        assert "world full" in sv.status
        assert sv.cam == world.modules["renderer"].active_camera >= 0


# -- the physics view ---------------------------------------------------------------------

def joint_world(pkg):
    Engine = mod(pkg, "engine.engine").Engine
    engine = Engine()
    if pkg == "torch":
        engine.device = torch.device("cpu")
    engine.module_capacities = {"actors": 8, "joints": 4}
    phys = mod(pkg, "physics.module").PhysicsSystem(engine)
    engine.add_system(phys)
    world = engine.create_world(capacity=16)
    a = world.create_entity(position=(0.0, 4.0, 0.0), name="anchor")
    b = world.create_entity(position=(0.0, 2.0, 0.0), name="bob")
    world.create_component(a, "rigid_actor", motion="static", shape="sphere", radius=0.2)
    world.create_component(b, "rigid_actor", motion="dynamic", shape="box",
                           half_extents=(0.3, 0.3, 0.3))
    world.create_component(b, "hinge_joint", body_a=a, body_b=b,
                           axis=(0.0, 0.0, 1.0), limit=(-0.5, 0.5))
    return engine, world, phys


def test_physics_view_joint_rows_and_gizmos_match_reference():
    out = {}
    for pkg in ("jax", "torch"):
        engine, world, phys = joint_world(pkg)
        pv = mod(pkg, "editor.physics_view").PhysicsView(engine, world)
        rows = [{k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in r.items()}
                for r in pv.joint_rows()]
        segs = [(np.asarray(p0).tolist(), np.asarray(p1).tolist(), c)
                for p0, p1, c in pv.overlay_segments()]
        screens = [pv.render_text(100, 24)]
        keys(pv, "g", DOWN)
        screens.append(pv.render_text(100, 24))
        keys(pv, "m", DOWN, RIGHT, " ", "n", "quiet", ENTER)
        screens.append(pv.render_text(120, 40))
        out[pkg] = (rows, segs, screens, np.asarray(phys.layer_matrix).copy(),
                    list(phys.layer_names))
    assert out["torch"][0] == out["jax"][0]
    assert len(out["torch"][1]) >= 8
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]
    np.testing.assert_array_equal(out["torch"][3], out["jax"][3])
    assert out["torch"][4] == out["jax"][4] and out["torch"][4][1] == "quiet"


def layer_world(pkg):
    """Two stacked boxes on a static slab, with the demo renderer (the scene
    view's camera): box 0 resting on the slab, box 1 in layer 1 falling onto
    box 0 from 0.1 m; the slab and box 0 in layer 0."""
    engine, _renderer = mod(pkg, "models.demo_scenes").build_engine(model_instances=8)
    if pkg == "torch":
        engine.device = torch.device("cpu")
    engine.module_capacities = {"actors": 8, "joints": 4}
    phys = mod(pkg, "physics.module").PhysicsSystem(engine)
    engine.add_system(phys)
    world = engine.create_world(capacity=16)
    s = world.create_entity(position=(0.0, -0.5, 0.0), name="slab")
    world.create_component(s, "rigid_actor", motion="static", shape="box",
                           half_extents=(4.0, 0.5, 4.0))
    for i, (y, layer) in enumerate(((0.5, 0), (1.6, 1))):
        e = world.create_entity(position=(0.0, y, 0.0), name=f"box{i}")
        world.create_component(e, "rigid_actor", motion="dynamic", shape="box",
                               half_extents=(0.5, 0.5, 0.5), layer=layer)
    return engine, world, phys


def test_physics_view_layer_edit_reaches_the_next_step():
    """Play the scene view until box 1 rests on box 0, toggle the 1×0 pair
    off in the physics view's layer matrix, play one more frame: the port's
    scene view rebuilds its step on the changed statics by itself (the JAX
    package's Runner is rebuilt by hand: its jitted step holds the matrix it
    was traced with), the pair's contacts go inactive in both, and the
    bodies agree within the step tolerances throughout."""
    views, pvs = {}, {}
    for pkg in ("jax", "torch"):
        engine, world, phys = layer_world(pkg)
        views[pkg] = mod(pkg, "editor.scene_view").SceneView(engine, world, width=32, height=18)
        pvs[pkg] = mod(pkg, "editor.physics_view").PhysicsView(engine, world)
        keys(views[pkg], "g")
    errs = {}

    def compare_bodies():
        got, ref = states(views)
        for k, atol in (("pos", BODY_POS_ATOL), ("rot", BODY_POS_ATOL),
                        ("vel", BODY_VEL_ATOL), ("angvel", BODY_VEL_ATOL)):
            k = "modules.physics." + k
            errs[k] = max(errs.get(k, 0.0), float(np.abs(got[k] - ref[k]).max()))
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k)
        for k in ("modules.physics.counters.active_contacts", "frame"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        return got["modules.physics.counters.active_contacts"].copy()

    for _ in range(12):                  # box 1 lands on box 0 at frame 10
        for v in views.values():
            v.frame()
    active0 = compare_bodies()
    for pkg, pv in pvs.items():
        keys(pv, "m", DOWN, " ")
        assert not pv.system.layer_matrix[1, 0]
    views["jax"].runner()._rebuild_after_structure_change(())
    for v in views.values():
        v.frame()
    active1 = compare_bodies()
    assert active1.sum() < active0.sum()
    print("layer edit: active contacts", active0.tolist(), "->", active1.tolist(), errs)


# -- the profiler view --------------------------------------------------------------------

def test_profiler_ui_matches_reference(monkeypatch):
    out = {}
    for pkg in ("jax", "torch"):
        profiler = mod(pkg, "core.profiler")
        ticks = iter(range(1, 10 ** 6))
        monkeypatch.setattr(profiler, "time",
                            types.SimpleNamespace(perf_counter=lambda: next(ticks) * 1e-3))
        profiler.clear()
        profiler.enable(True)
        profiler.pause(False)
        for _ in range(3):
            with profiler.block("frame_work"):
                with profiler.block("physics"):
                    pass
                with profiler.block("render"):
                    with profiler.block("cull"):
                        pass
            profiler.frame()
        profiler.push_counter("visible_count", 42.0)
        profiler.push_counter("visible_count", 64.0)
        ui = mod(pkg, "editor.profiler_ui").ProfilerUI()
        ui.snapshot()
        t0, t1 = ui.window()
        log = [ui.frame_spans(), (t0, t1), ui.flame_rows(t0 - 1.0, t1 + 1.0),
               ui.render_text(100, 24)]
        keys(ui, "c")
        log.append(ui.render_text(100, 24))
        keys(ui, "c", LEFT, LEFT, RIGHT, " ")
        log += [ui.frame_sel, ui.render_text(100, 24)]
        profiler.pause(False)
        profiler.enable(False)
        profiler.clear()
        out[pkg] = log
    assert len(out["torch"][2]) >= 3
    assert out["torch"] == out["jax"]


# -- assets: the browser, the material editor, the meta editor ----------------------------

@pytest.fixture
def asset_dir(tmp_path):
    d = str(tmp_path / "assets")
    AS.write_assets(d)
    with open(os.path.join(d, "fire.pat"), "w") as f:
        f.write("emitter fire {\n  material \"particle.mat\"\n  init_emit_count 4\n"
                "  out i_position : float3\n  fn emit() { i_position.x = random(0, 1); }\n}\n")
    with open(os.path.join(d, "broken.pat"), "w") as f:
        f.write("emitter e { fn update( }")
    with open(os.path.join(d, "tone.wav"), "wb") as f:
        import wave

        w = wave.open(f, "wb")
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(np.zeros(800, np.int16).tobytes())
        w.close()
    mod("torch", "importers.unv_write").save_unv(
        H.stress_scene(entities=40, bodies=2, agents=2, scripts=1), os.path.join(d, "level.unv"))
    return d


def compiler(pkg):
    ac = mod(pkg, "editor.asset_compiler").AssetCompiler()
    mod(pkg, "importers.model_meta").register(ac)
    return ac


def test_asset_browser_entries_details_and_keys_match_reference(asset_dir):
    out = {}
    for pkg in ("jax", "torch"):
        ab = mod(pkg, "editor.asset_browser").AssetBrowser((asset_dir,), compiler=compiler(pkg))
        log = [[(e.path, e.type, e.size) for e in ab.entries]]
        for e in ab.entries:
            det = ab.details(e)
            # an error names a buffer object by its address
            log.append({k: (re.sub(r" at 0x[0-9a-f]+", "", v) if isinstance(v, str) else v)
                        for k, v in det.items()})
        keys(ab, ENTER)
        log.append(ab.render_text(100, 30))
        keys(ab, "fbx")
        log.append([e.path for e in ab.visible()])
        keys(ab, DOWN, DOWN, UP)
        log.append(ab.render_text(100, 30))
        keys(ab, "!")
        log.append(ab.status)
        keys(ab, 8, 8, 8, "pat", DOWN)
        log += [ab.render_text(100, 30), ab.recompile(ab.selected())]
        out[pkg] = log
    types_ = {t for _p, t, _s in out["torch"][0]}
    assert {"model", "world", "particle_script", "material", "animation", "audio"} <= types_
    for i, (a, b) in enumerate(zip(out["jax"], out["torch"])):
        assert b == a, i


def _material_script(pkg, path):
    ed = mod(pkg, "editor.material_editor").MaterialEditor(path)
    log = [ed.rows(), ed.render_text(100, 24)]
    keys(ed, "b")
    log.append(ed.mat.backface_culling)
    keys(ed, "u")
    ed.sel = next(i for i, r in enumerate(ed.rows()) if r[0].startswith("uniform:"))
    keys(ed, ENTER, "{ 0.5, 0.25, 0.125, 1 }", ENTER)
    log += [ed.rows(), ed.status]
    keys(ed, ENTER, "wat", ENTER)
    log.append(ed.status)
    keys(ed, DOWN, ENTER, "0.75", ENTER, "s")
    log += [ed.dirty, open(path).read(), ed.render_text(100, 24)]
    return log


def test_material_editor_edit_undo_save_matches_reference(asset_dir, tmp_path):
    out = {}
    for pkg in ("jax", "torch"):
        path = str(tmp_path / pkg[0] / "rock.mat")      # equal lengths
        os.makedirs(os.path.dirname(path))
        shutil.copy(os.path.join(asset_dir, AS.MAT), path)
        out[pkg] = [x.replace(os.path.dirname(path), "<d>") if isinstance(x, str) else x
                    for x in _material_script(pkg, path)]
    assert out["torch"] == out["jax"]


def _meta_script(pkg, path):
    ac = compiler(pkg)
    ed = mod(pkg, "editor.meta_editor").MetaEditor(path, compiler=ac)
    log = [ed.rows(), ed.render_text(80, 20)]
    ed.sel = [k for k, _ in ed.rows()].index("physics")
    keys(ed, ENTER)
    ed.sel = [k for k, _ in ed.rows()].index("scale")
    keys(ed, ENTER, "2.5", ENTER)
    log += [ed.rows(), ed.dirty]
    keys(ed, "s")
    log.append(ed.status)
    meta = mod(pkg, "importers.model_meta").load_meta_for(path)
    res = ac.compile(path)
    log += [open(path + ".meta").read(), (meta.physics, meta.scene_scale),
            (res["meta"].scene_scale, res["physics"][0] if res["physics"] else None),
            ed.render_text(80, 20)]
    return log


def test_meta_editor_edit_save_recompile_matches_reference(asset_dir, tmp_path):
    out = {}
    for pkg in ("jax", "torch"):
        path = str(tmp_path / pkg[0] / "level.fbx")
        os.makedirs(os.path.dirname(path))
        shutil.copy(os.path.join(asset_dir, AS.PROPS["rock"]), path)
        out[pkg] = [x.replace(os.path.dirname(path), "<d>") if isinstance(x, str) else x
                    for x in _meta_script(pkg, path)]
    assert "convex" in out["torch"][5]
    assert out["torch"] == out["jax"]


def test_editor_app_asset_meta_and_material_views_match_reference(asset_dir, tmp_path):
    """EditorApp '2' over the written assets, '@' on a model opens the meta
    editor, '9' opens the first .mat; typed 'q's do not quit."""
    from test_torch_editor_app import make_app

    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg[0]
        d.mkdir()
        engine, world, _ = mod(pkg, "models.demo_scenes").headless_demo_world(num_entities=32)
        if pkg == "torch":
            engine.device = torch.device("cpu")
        app = make_app(pkg, engine, world, d, data_dir=asset_dir)
        keys(app, "2")
        log = [app.render_text(80, 20)]
        ab = app.asset_browser()
        ab.filter = "box.fbx"
        ab.sel = 0
        keys(app, "@")
        assert app.view == "meta"
        log.append(app.render_text(80, 20))
        app.meta_editor().sel = [k for k, _ in app.meta_editor().rows()].index("scale")
        keys(app, ENTER, "q")
        assert not app.quit_requested
        keys(app, ESC, ESC)
        assert app.view == "main"
        keys(app, "9")
        assert app.view == "material"
        log.append(app.render_text(100, 24))
        keys(app, ENTER, "q")
        assert app.material_editor().edit == "q" and not app.quit_requested
        keys(app, ESC, ESC)
        log.append(app.render_text(80, 12))
        out[pkg] = log
    assert out["torch"] == out["jax"]
