"""The editor application in the port (editor/app.py and its host views:
log, settings, spline, the signal editor, prefabs, docking) against the JAX
package, on the CPU. Each test drives one key script through both
packages' ``EditorApp`` and compares, after every step:

* ``render_text`` string for string (the profiler's recorder on a fixed
  clock; the test's directory masked in both);
* the host world (entity rows, names, every module's component records)
  bit for bit;
* what the editor writes: the saved world blob and ``.fab`` byte for byte,
  the settings ini text, the saved ``.unv`` byte for byte.

The scripts are tests/test_editor_app.py's, test_dock_layout.py's,
test_signal_editor.py's, test_prefab_workflow.py's, test_settings_ui.py's,
test_log_ui.py's and test_spline_editor.py's flows, on
``demo_scenes.headless_demo_world(256)`` and on a ``.unv`` the test writes.
The asset browser of either package is pointed at a directory the test
writes (the JAX app's default data directories do not exist here).
"""
import importlib
import os
import types

import numpy as np
import pytest
import torch

from lumixengine_tpu_torch.models import host_scenes as H

torch.set_num_threads(2)

PKG = {"jax": "lumixengine_tpu", "torch": "lumixengine_tpu_torch"}
UP, DOWN, TAB, ENTER, ESC, BACK = 0x26, 0x28, 9, 13, 27, 8


def mod(pkg, name):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


def engine_kw(pkg):
    return {"device": "cpu"} if pkg == "torch" else {}


def demo_app(pkg, tmp_path, n=256):
    engine, world, _ = mod(pkg, "models.demo_scenes").headless_demo_world(num_entities=n)
    if pkg == "torch":
        engine.device = torch.device("cpu")
    return make_app(pkg, engine, world, tmp_path)


def make_app(pkg, engine, world, tmp_path, data_dir=None):
    ini = str(tmp_path / f"{pkg}.ini")
    A = mod(pkg, "editor.app")
    if pkg == "torch":
        return A.EditorApp(engine, world, settings_path=ini,
                           data_dirs=(data_dir,) if data_dir else None)
    app = A.EditorApp(engine, world, settings_path=ini)
    if data_dir:
        app._asset_browser = None
        _jax_browser(app, data_dir)
    return app


def _jax_browser(app, data_dir):
    """The JAX app's asset browser, built as its own ``asset_browser()``
    builds it, over `data_dir` in place of its default data directories."""
    import lumixengine_tpu.importers.instantiate as inst

    saved = inst.DEFAULT_DATA_DIRS
    inst.DEFAULT_DATA_DIRS = (data_dir,)
    try:
        app.asset_browser()
    finally:
        inst.DEFAULT_DATA_DIRS = saved


def host_rows(pkg, world):
    ser = mod(pkg, "engine.serialize")
    rows = {k: np.asarray(getattr(world, k)).copy()
            for k in ("alive", "parent", "local_pos", "local_rot", "local_scale")}
    rows["names"] = dict(world.names)
    rows["components"] = {n: ser._dump_module_components(m) for n, m in world.modules.items()}
    return rows


def assert_rows_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            assert b[k] == a[k], k


def keys(app, *seq):
    """Feed keys: an int is a key code, a str is typed character by character."""
    for k in seq:
        if isinstance(k, int):
            app.handle_key(k)
        else:
            for ch in k:
                app.handle_key(0, ch)


def compare_runs(script, tmp_path):
    """script(pkg, app_dir) -> list of ("screen"|"rows"|"bytes"|"value", x)."""
    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg[0]       # equal lengths: status lines truncate
        d.mkdir()
        out[pkg] = [(k, x.replace(str(d), "<dir>") if isinstance(x, str) else x)
                    for k, x in script(pkg, d)]
    assert len(out["jax"]) == len(out["torch"]) > 0
    for i, ((kind, a), (kind2, b)) in enumerate(zip(out["jax"], out["torch"])):
        assert kind == kind2
        if kind == "rows":
            assert_rows_equal(a, b)
        elif kind == "screen":
            assert b == a, f"screen {i} differs"
        else:
            assert b == a, f"{kind} {i} differs"
    return out


# -- tests/test_editor_app.py ---------------------------------------------------------------

def test_tree_navigation_and_edits_match_reference(tmp_path):
    def script(pkg, d):
        app = demo_app(pkg, d)
        world = app.world
        log = [("screen", app.render_text(100, 24))]
        first = app.selected_entity()
        keys(app, DOWN)
        assert app.selected_entity() != first
        keys(app, UP)
        assert app.selected_entity() == first
        # transform.x through the undo stack
        keys(app, TAB, ENTER, "42.5", ENTER)
        log += [("rows", host_rows(pkg, world)), ("screen", app.render_text(100, 24))]
        keys(app, "u")
        log += [("rows", host_rows(pkg, world)), ("screen", app.render_text(100, 24))]
        keys(app, "y")
        log += [("rows", host_rows(pkg, world))]
        # a reflected camera property
        ents = app.entities()
        app.sel = next(i for i, (e, _) in enumerate(ents)
                       if world.get_entity_name(e) == "camera")
        e = app.selected_entity()
        rows = app.prop_rows(e)
        log.append(("value", [(c, p, repr(v)) for c, p, v in rows]))
        app.prop_sel = next(i for i, (c, p, v) in enumerate(rows)
                            if c == "camera" and np.isscalar(v))
        keys(app, ENTER, "0.75")
        log.append(("screen", app.render_text(100, 24)))
        keys(app, ENTER)
        assert "= 0.75" in app.status
        log += [("rows", host_rows(pkg, world)), ("screen", app.render_text(100, 24))]
        keys(app, ENTER, "abc", ENTER, ENTER, "1x", ESC)
        log += [("value", app.status), ("screen", app.render_text(100, 24))]
        return log

    compare_runs(script, tmp_path)


def test_create_destroy_save_quit_match_reference(tmp_path):
    def script(pkg, d):
        engine, _r = mod(pkg, "models.demo_scenes").build_engine(model_instances=16)
        if pkg == "torch":
            engine.device = torch.device("cpu")
        world = engine.create_world(capacity=16)
        world.create_entity(name="camera")
        app = make_app(pkg, engine, world, d)
        n0 = world.entity_count
        keys(app, "n")
        assert world.entity_count == n0 + 1
        log = [("rows", host_rows(pkg, world))]
        keys(app, DOWN, "x")
        log += [("rows", host_rows(pkg, world)), ("screen", app.render_text(80, 16))]
        keys(app, "u")
        assert world.entity_count == n0 + 1
        log.append(("rows", host_rows(pkg, world)))
        app.save_path = str(d / "edited.sav")
        keys(app, "s")
        blob = open(app.save_path, "rb").read()
        assert len(blob) > 100
        log.append(("bytes", blob))
        keys(app, "q")
        assert app.quit_requested
        return log

    compare_runs(script, tmp_path)


# -- tests/test_dock_layout.py, tests/test_log_ui.py ----------------------------------------

def test_dock_cycle_and_log_view_match_reference(tmp_path):
    def script(pkg, d):
        core_log = mod(pkg, "core.log")
        app = demo_app(pkg, d, n=32)
        world = app.world
        log = [("screen", app.render_text(80, 24))]
        keys(app, "D")
        assert app.dock == "log"
        app.render_text(80, 24)
        app.log_ui()._clock = lambda: 0.0     # notifications do not fade mid-script
        core_log.log_warning("dock", "visible in the split")
        log.append(("screen", app.render_text(80, 24)))
        n0 = world.entity_count
        keys(app, "x")
        assert world.entity_count == n0 - 1
        log.append(("rows", host_rows(pkg, world)))
        app.stack.undo()
        log.append(("rows", host_rows(pkg, world)))
        keys(app, "D")
        assert app.dock == "profiler"
        keys(app, "D")
        assert app.dock == "scene"
        log.append(("screen", app.render_text(80, 24)))
        keys(app, "D")
        assert app.dock is None
        keys(app, "1")
        assert app.view == "log"
        core_log.log_info("test", "hello from the log view")
        core_log.log_error("asset", "cannot open foo.fbx")
        log.append(("screen", app.render_text(80, 12)))
        keys(app, "i")
        log.append(("screen", app.render_text(80, 12)))
        keys(app, "f", "asset", ENTER)
        log.append(("screen", app.render_text(80, 12)))
        keys(app, "f", "q")
        assert not app.quit_requested
        keys(app, ESC, ESC)
        assert app.view == "main"
        app.log_ui().close()
        return log

    compare_runs(script, tmp_path)


def test_profiler_view_and_its_dock_match_reference(tmp_path, monkeypatch):
    """The profiler pane over two recorded frames in each package, the
    recorder's clock a fixed 1 ms tick in both so that the flame rows are
    equal."""
    def script(pkg, d):
        profiler = mod(pkg, "core.profiler")
        ticks = iter(range(1, 10 ** 6))
        monkeypatch.setattr(profiler, "time",
                            types.SimpleNamespace(perf_counter=lambda: next(ticks) * 1e-3))
        profiler.clear()
        profiler.enable(True)
        profiler.pause(False)
        for _ in range(2):
            with profiler.block("frame_work"):
                with profiler.block("physics"):
                    pass
                with profiler.block("render"):
                    with profiler.block("cull"):
                        pass
            profiler.frame()
        profiler.push_counter("visible_count", 42.0)
        profiler.push_counter("visible_count", 64.0)
        profiler.enable(False)
        app = demo_app(pkg, d, n=32)
        keys(app, "3")
        assert app.view == "profiler"
        log = [("screen", app.render_text(80, 20))]
        keys(app, "c")
        log.append(("screen", app.render_text(80, 20)))
        keys(app, "c", 0x25, 0x25, 0x27)
        log.append(("value", app.profiler_ui().frame_sel))
        keys(app, "D")
        assert app.dock == "log" and app.view == "profiler"
        log.append(("screen", app.render_text(80, 24)))
        app.log_ui().close()
        profiler.clear()
        return log

    compare_runs(script, tmp_path)


# -- tests/test_signal_editor.py ------------------------------------------------------------

@pytest.fixture
def own_registries():
    """Each package's reflection registry holding only what the package
    registers itself: its built-in schemas and the script module's signal
    function. The registries are process-global, and other test files add
    modules to the JAX one (a ``test_sink``, a light's ``turn_off``); the
    signal editor lists and cycles through every registered event and
    function, so what ran earlier in the process would show in its lists."""
    saved = []
    for pkg in PKG:
        reflection = mod(pkg, "engine.reflection")
        signal_call = mod(pkg, "script.module")._signal_call
        modules = reflection.registry.modules
        saved.append((modules, dict(modules)))
        modules.clear()
        reflection.register_builtin_components()
        reflection.registry.module("script").func("call", signal_call)
    yield
    for modules, before in saved:
        modules.clear()
        modules.update(before)


def signal_cycle(tmp_path):
    def script(pkg, d):
        engine = mod(pkg, "app").create_full_engine(**engine_kw(pkg))
        world = engine.create_world(capacity=8)
        btn = world.create_entity(name="button")
        world.create_component(btn, "signal", event_component="gui", event="buttonClicked",
                               function_component="script", function="call",
                               target_entity=btn)
        app = make_app(pkg, engine, world, d)
        reg = mod(pkg, "engine.reflection").registry
        log = [("value", reg.all_events()), ("value", reg.all_functions())]
        app.sel = app.entities().index((btn, 0))
        app.panel = "props"
        rows = app.prop_rows(btn)
        log.append(("value", [(c, p, repr(v)) for c, p, v in rows]))
        app.prop_sel = [i for i, r in enumerate(rows) if r[:2] == ("signal", "event")][0]
        for _ in range(3):
            keys(app, "c")
            log += [("rows", host_rows(pkg, world)), ("value", app.status)]
        app.stack.undo()
        app.stack.undo()
        log.append(("rows", host_rows(pkg, world)))
        app.prop_sel = [i for i, r in enumerate(rows) if r[:2] == ("signal", "function")][0]
        keys(app, "c")
        log += [("rows", host_rows(pkg, world)), ("screen", app.render_text(100, 12))]
        return log

    compare_runs(script, tmp_path)


def test_signal_cycle_with_undo_matches_reference(tmp_path, own_registries):
    signal_cycle(tmp_path)


def test_signal_cycle_after_a_foreign_registration_matches_reference(tmp_path, request):
    """tests/test_gui_audio.py registers a ``test_sink`` module into the JAX
    registry; a signal cycle run after it in the same process compares the
    same lists as one run alone."""
    reflection = mod("jax", "engine.reflection")
    reflection.register_builtin_components()
    modules = reflection.registry.modules
    before = dict(modules)
    request.addfinalizer(lambda: (modules.clear(), modules.update(before)))
    reflection.registry.module("test_sink").func("record", lambda module, entity: None)
    request.getfixturevalue("own_registries")
    signal_cycle(tmp_path)


# -- tests/test_prefab_workflow.py ----------------------------------------------------------

def test_prefab_save_instantiate_undo_matches_reference(tmp_path):
    def script(pkg, d):
        engine = mod(pkg, "app").create_full_engine(base_path=str(d), **engine_kw(pkg))
        world = engine.create_world(capacity=64)
        cam = world.create_entity(position=(0.0, 2.0, 10.0), name="camera")
        world.create_component(cam, "camera")
        root = world.create_entity(position=(1.0, 2.0, 3.0), name="turret")
        world.create_entity(position=(0.0, 1.0, 0.0), parent=root, name="barrel")
        world.create_component(root, "point_light", intensity=4.0)
        app = make_app(pkg, engine, world, d)
        app.sel = app.entities().index((root, 0))
        keys(app, "p")
        assert "prefab saved" in app.status
        log = [("bytes", (d / "turret.fab").read_bytes())]
        keys(app, "P")
        assert "2 entities instantiated" in app.status
        log += [("rows", host_rows(pkg, world)), ("screen", app.render_text(100, 16))]
        app.stack.undo()
        log.append(("rows", host_rows(pkg, world)))
        app.stack.redo()
        log.append(("rows", host_rows(pkg, world)))
        ab = mod(pkg, "editor.asset_browser").AssetBrowser((str(d),))
        log.append(("value", [(e.path, e.type) for e in ab.entries]))
        return log

    compare_runs(script, tmp_path)


# -- tests/test_settings_ui.py --------------------------------------------------------------

def test_settings_edit_persist_and_reset_match_reference(tmp_path):
    def script(pkg, d):
        engine = mod(pkg, "engine.engine").Engine()
        world = engine.create_world(capacity=8)
        app = make_app(pkg, engine, world, d)
        keys(app, ",")
        assert app.view == "settings"
        ui = app.settings_ui()
        log = [("screen", app.render_text(80, 20))]
        ui.sel = ui.rows().index("time_multiplier")
        keys(app, ENTER, "2.5", ENTER)
        assert engine.time_multiplier == 2.5
        ui.sel = ui.rows().index("autoscroll")
        keys(app, ENTER)
        ui.sel = ui.rows().index("move_speed")
        keys(app, ENTER, "abc", ENTER)
        log += [("value", ui.status), ("screen", app.render_text(80, 20))]
        keys(app, "s")
        log.append(("value", open(app.settings_path).read()))
        app2 = make_app(pkg, mod(pkg, "engine.engine").Engine(), world, d)
        log.append(("value", (app2.engine.time_multiplier, app2.settings.get("autoscroll"))))
        ui2 = app2.settings_ui()
        ui2.sel = ui2.rows().index("time_multiplier")
        ui2.handle_key(0, "r")
        keys(app2, ",")
        log += [("value", app2.engine.time_multiplier), ("screen", app2.render_text(80, 20))]
        return log

    compare_runs(script, tmp_path)


def test_settings_push_into_the_scene_view(tmp_path):
    """tests/test_settings_ui.py's live push, in the port."""
    app = demo_app("torch", tmp_path, n=32)
    app.settings.set("move_speed", 7.5)
    app._apply_setting("move_speed")
    sv = app.scene_view()
    assert sv.move_speed == 7.5
    app.settings.set("move_speed", 3.25)
    app.settings_ui().on_change("move_speed")
    assert sv.move_speed == 3.25


# -- tests/test_spline_editor.py ------------------------------------------------------------

def test_spline_editor_flow_matches_reference(tmp_path):
    def script(pkg, d):
        engine = mod(pkg, "app").create_full_engine(**engine_kw(pkg))
        world = engine.create_world(capacity=16)
        cam = world.create_entity(position=(0.0, 2.0, 10.0), name="camera")
        world.create_component(cam, "camera")
        app = make_app(pkg, engine, world, d)
        keys(app, ".")
        assert app.view == "main" and "no splines" in app.status
        e = world.create_entity(position=(10.0, 0.0, 0.0), name="track")
        world.modules["core"].create_component(e, "spline",
                                               points=[[0, 0, 0], [2, 0, 0], [4, 1, 0]])
        keys(app, ".")
        assert app.view == "spline"
        ed = app.spline_editor()
        log = [("screen", app.render_text(80, 16))]
        keys(app, "a")
        log.append(("rows", host_rows(pkg, world)))
        app.stack.undo()
        ed.sel_point = 1
        keys(app, "l", "l", "o")
        log += [("rows", host_rows(pkg, world)), ("value", len(app.stack._undo))]
        app.stack.undo()
        ed.sel_point = 2
        keys(app, ENTER, "5 2 -1", ENTER)
        log += [("rows", host_rows(pkg, world)), ("screen", app.render_text(80, 16))]
        keys(app, "x")
        log.append(("rows", host_rows(pkg, world)))
        app.stack.undo()
        segs = ed.overlay_segments()
        log.append(("value", [(np.asarray(a, np.float32).tolist(),
                               np.asarray(b, np.float32).tolist(), c) for a, b, c in segs]))
        if pkg == "torch":
            world.modules["core"].prepare_statics("cpu")   # the bank's device
        log.append(("value", float(world.modules["core"].bank.total_len[0])))
        keys(app, ESC)
        assert app.view == "main"
        return log

    compare_runs(script, tmp_path)


# -- a .unv world: open, edit, save, reload --------------------------------------------------

def _open_unv(pkg, path, data_dir, d):
    if pkg == "torch":
        return mod(pkg, "editor.app").open_world(path, "cpu", settings_path=str(d / "e.ini"),
                                                  data_dirs=(data_dir,))
    inst = mod(pkg, "importers.instantiate").load_world(path, data_dirs=(data_dir,))
    app = make_app(pkg, inst.engine, inst.world, d)
    app.scene_inst = inst
    app.save_path = "world_edited.unv"
    return app


def test_unv_world_edit_save_reload_matches_reference(tmp_path):
    """main's `--world x.unv` path: open a written stress scene, edit a
    transform and a light, create and destroy entities with undo and redo,
    save it back as .unv (equal bytes), and reload the saved file (equal
    worlds)."""
    data_dir = str(tmp_path / "data")
    H.write_stress_nav(data_dir)
    src = str(tmp_path / "stress.unv")
    mod("torch", "importers.unv_write").save_unv(
        H.stress_scene(entities=160, bodies=6, agents=4, scripts=2), src)

    def script(pkg, d):
        app = _open_unv(pkg, src, data_dir, d)
        world = app.world
        log = [("screen", app.render_text(100, 24))]
        keys(app, DOWN, DOWN, TAB, ENTER, "7.5", ENTER, TAB)
        ents = app.entities()
        app.sel = next(i for i, (e, _) in enumerate(ents)
                       if world.get_entity_name(e) == "light0")
        rows = app.prop_rows(app.selected_entity())
        app.panel = "props"
        app.prop_sel = next(i for i, (c, p, v) in enumerate(rows)
                            if (c, p) == ("point_light", "intensity"))
        keys(app, ENTER, "3.5", ENTER, TAB)
        log += [("rows", host_rows(pkg, world)), ("screen", app.render_text(100, 24))]
        keys(app, "n", "u", "y")
        app.sel = len(app.entities()) - 1
        keys(app, UP, "x", "u", "y")
        log += [("rows", host_rows(pkg, world)), ("screen", app.render_text(100, 24))]
        app.save_path = str(d / "edited.unv")
        keys(app, "s")
        data = open(app.save_path, "rb").read()
        log.append(("bytes", data))
        (d / "again").mkdir()
        again = _open_unv(pkg, app.save_path, data_dir, d / "again")
        log += [("rows", host_rows(pkg, again.world)), ("screen", again.render_text(100, 24))]
        return log

    compare_runs(script, tmp_path)
