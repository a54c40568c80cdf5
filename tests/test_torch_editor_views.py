"""The editor's device views in the port (editor/) against the JAX package,
on the CPU:

* ``GameView``: play snapshots the world (``serialize_world``), ticks it
  through the Runner, stop restores it (``load_world``) and hands it to
  ``on_world_replaced``: the restored world equals the pre-play one and the
  JAX package's restored world (host rows, component records and the device
  state, bit for bit); the controls (time multiplier, pause, single step,
  forced viewport, the depth view) as tests/test_game_view.py has them;
* ``AnimGraphEditor`` on the locomotion controller of
  ``demo_scenes.build_engine``: equal tree rows, and preview slots (clip,
  time, weight) and clocks within ATOL frame by frame as an input moves;
  typed inputs, pause and the ``.act`` save through ``write_act``;
* ``ParticleEditor``: the compile errors, the save, and 30 preview frames
  of a script that draws random numbers, with equal live counts and the
  emitter states within PARTICLE_ATOL of the JAX package's preview (the
  same loop: ``PRNGKey(0)`` split once a frame);
* ``VoxelizerUI`` on a written FBX: grid, AO, blur, slice and the text
  view equal.
"""
import importlib
import io

import numpy as np
import pytest
import torch

from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.models import asset_scenes as A
from test_torch_bridge import ref_to_numpy

torch.set_num_threads(2)

PKG = {"jax": "lumixengine_tpu", "torch": "lumixengine_tpu_torch"}
ATOL = 1e-6             # controller clocks and weights: the same float32 formulas
PARTICLE_ATOL = 1e-5    # particle channels over 30 frames, |values| <= ~5
_UP, _DOWN, _TAB, _ENTER = 0x26, 0x28, 9, 13


def mod(pkg, name):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


# -- the game view ----------------------------------------------------------------------

def game_view(pkg, n=64):
    engine, world, _ = mod(pkg, "models.demo_scenes").headless_demo_world(num_entities=n)
    if pkg == "torch":
        engine.device = torch.device("cpu")
    replaced = []
    return mod(pkg, "editor.game_view").GameView(engine, world, replaced.append), replaced


def world_rows(pkg, world):
    ser = mod(pkg, "engine.serialize")
    rows = {k: np.asarray(getattr(world, k)).copy()
            for k in ("alive", "parent", "local_pos", "local_rot", "local_scale")}
    rows["names"] = dict(world.names)
    rows["components"] = {n: ser._dump_module_components(m) for n, m in world.modules.items()}
    rows["state"] = (ref_to_numpy(world.device_state()) if pkg == "jax"
                     else bridge.state_to_numpy(world.device_state("cpu")))
    return rows


def assert_rows_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "state":
            assert set(a[k]) == set(b[k])
            for f in a[k]:
                np.testing.assert_array_equal(b[k][f], a[k][f], err_msg=f)
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            assert b[k] == a[k], k


def _play_and_mutate(gv):
    world = gv.world
    probe = next(e for e in range(world.capacity) if world.is_alive(e) and world.parent[e] < 0)
    gv.toggle_play()
    assert gv.playing and gv.engine.game_running
    for _ in range(3):
        gv.tick_frame()
    assert gv.frames == 3
    parents = {int(p) for p in world.parent if p >= 0}
    victim = next(e for e in range(world.capacity) if world.is_alive(e)
                  and world.parent[e] < 0 and e != probe and e not in parents)
    world.destroy_entity(victim)
    world.create_entity(name="runtime_spawn")
    world.set_local_transform(probe, position=(9.0, 9.0, 9.0))
    gv.toggle_play()
    return victim


def test_game_view_play_stop_restores_the_world():
    before, restored = {}, {}
    for pkg in ("jax", "torch"):
        gv, replaced = game_view(pkg)
        world = gv.world
        before[pkg] = world_rows(pkg, world)
        victim = _play_and_mutate(gv)
        assert not gv.playing and not gv.engine.game_running
        assert gv.world is not world and replaced == [gv.world]
        assert gv.world.is_alive(victim)
        restored[pkg] = world_rows(pkg, gv.world)
        assert_rows_equal(before[pkg], restored[pkg])
    assert_rows_equal(restored["jax"], restored["torch"])
    assert_rows_equal(before["jax"], before["torch"])


def test_game_view_controls():
    gv, _ = game_view("torch")
    engine = gv.engine
    m0 = engine.time_multiplier
    gv.handle_key(0, "+")
    assert engine.time_multiplier > m0
    for _ in range(40):
        gv.handle_key(0, "-")
    assert engine.time_multiplier >= 0.01
    for _ in range(60):
        gv.handle_key(0, "+")
    assert engine.time_multiplier <= 30.0
    gv.handle_key(0, "g")
    gv.handle_key(0, " ")
    assert engine.paused
    f0 = gv.frames
    gv.tick_frame()
    gv.handle_key(0, "n")
    assert gv.frames == f0 + 2
    gv.handle_key(0, " ")
    assert not engine.paused
    gv.handle_key(0, "v")
    assert gv.forced_viewport == (320, 180)
    img = gv.frame(64, 64)
    assert img.shape == (180, 320, 3) and img.dtype == np.uint8
    gv.handle_key(0, "v")
    gv.handle_key(0, "v")
    assert gv.forced_viewport is None
    gv.handle_key(0, "b")
    assert gv.debug_show == "depth"
    img = gv.frame(48, 32)
    assert img.shape == (32, 48, 3) and (img[..., 0] == img[..., 1]).all()
    gv.handle_key(0, "b")
    gv.handle_key(0, "g")
    assert not engine.paused and not engine.game_running
    txt = gv.render_text(60, 12)
    assert "game view" in txt and "STOPPED" in txt and "\x1b[38;2;" in txt
    # the stopped view steps the edited world at dt 0 on the runner's device
    img = gv.frame(40, 24)
    assert gv.runner().device == torch.device("cpu") and img.shape == (24, 40, 3)


# -- the animation graph editor ---------------------------------------------------------

def anim_editor(pkg, **kw):
    _, _, anim = mod(pkg, "models.demo_scenes").build_engine(
        with_animation=True, model_instances=8, animators=8)
    if pkg == "torch":
        kw["device"] = "cpu"
    return mod(pkg, "editor.anim_editor").AnimGraphEditor(anim.controllers[0], **kw)


def test_anim_editor_tree_and_preview_equal():
    r, p = anim_editor("jax"), anim_editor("torch")
    assert [(d, s) for d, s, _ in p.tree_rows()] == [(d, s) for d, s, _ in r.tree_rows()]
    labels = [s for _, s, _ in p.tree_rows()]
    assert any("Blend1D" in s for s in labels) and sum("clip" in s for s in labels) == 3
    for i, keys in enumerate(([], [(_TAB, "")], [(0, "+")], [(0, "+"), (0, "+")],
                              [(0, "-")], [(0, "+")] * 4)):
        for ed in (r, p):
            for code, text in keys:
                ed.handle_key(code, text)
        for _ in range(5):
            r.step_preview()
            p.step_preview()
            assert len(p._last_slots) == len(r._last_slots)
            for a, b in zip(r._last_slots, p._last_slots):
                np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                                           atol=ATOL, rtol=0)
            np.testing.assert_allclose(p.clocks, r.clocks, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(p.inputs, r.inputs)
    weights = {int(c): float(w) for c, _t, w, _p in p._last_slots}
    assert abs(sum(weights.values()) - 1.0) < 1e-4
    assert p.render_text(96, 24) == r.render_text(96, 24)


def test_anim_editor_typing_pause_and_act_save(tmp_path):
    ed = anim_editor("torch")
    ed.handle_key(_TAB)
    ed.handle_key(_ENTER)
    for ch in "2.5":
        ed.handle_key(0, ch)
    ed.handle_key(_ENTER)
    assert float(ed.inputs[0, 0]) == 2.5
    ed.handle_key(0, " ")
    clocks = ed.clocks.copy()
    ed.step_preview()
    assert (ed.clocks == clocks).all()
    assert "anim graph" in ed.render_text(96, 24) and "speed" in ed.render_text(96, 24)
    ed.handle_key(0, "s")
    assert "no .act attached" in ed.status
    # a header attached: retarget and save through write_act, as the reference does
    blobs = []
    for pkg in ("jax", "torch"):
        act = mod(pkg, "importers.act")
        parsed = act.parse_act(A.act_bytes(A.CHARACTER, f".ani:{A.CHARACTER}"))
        path = tmp_path / f"{pkg}.act"
        e = anim_editor(pkg, parsed=parsed, act_path=str(path))
        e.retarget_entry(1, "anims/other.fbx")
        e.retarget_entry(7, "anims/new.fbx")
        e.handle_key(0, "s")
        assert "saved" in e.status
        blobs.append(path.read_bytes())
    assert blobs[1] == blobs[0]
    back = mod("torch", "importers.act").parse_act(blobs[1])
    assert back["entries"][1]["animation"] == "anims/other.fbx"
    assert back["entries"][-1] == {"slot": 7, "set": 0, "animation": "anims/new.fbx"}


# -- the particle editor ----------------------------------------------------------------

SIMPLE = """emitter test {
\tmax_particles 64
\tinit_emit_count 8
\tvar life : float
\tfn emit() {
\t\tlife = 1.0;
\t}
\tfn update() {
\t\tlife = life - time_delta;
\t\tif life < 0 { kill(); }
\t}
}
"""


def particle_editor(pkg, path, source=None):
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return mod(pkg, "editor.particle_editor").ParticleEditor(str(path), source, **kw)


def jax_preview(emitters, frames):
    """The JAX package's ParticleEditor.step_preview loop, keeping the
    states."""
    import jax
    import jax.numpy as jnp
    from lumixengine_tpu.renderer.particle_system import ParticleSystem

    sys_ = ParticleSystem(emitters, capacity_override={
        n: min(4096, max(c, 1)) for n, c in ParticleSystem(emitters).caps.items()})
    system = {n: jnp.zeros(w) if w > 1 else jnp.float32(0.0)
              for n, w in sys_.globals_decl.items()}
    system.setdefault("entity_position", jnp.zeros(3))
    states = sys_.device_state(system=system)
    key, t = jax.random.PRNGKey(0), 0.0
    for _ in range(frames):
        key, k = jax.random.split(key)
        states = sys_.step(states, jnp.float32(1 / 60), jnp.float32(t), k, system=system)
        t += 1 / 60
    return states


def test_particle_editor_compile_errors_and_save(tmp_path):
    eds = {}
    for pkg in ("jax", "torch"):
        p = tmp_path / f"{pkg}.pat"
        p.write_text(SIMPLE)
        ed = particle_editor(pkg, p)
        assert ed.error is None
        ed.handle_key(_DOWN)
        ed.handle_key(_ENTER)
        ed.edit = "\tmax_particles oops"
        ed.handle_key(_ENTER)
        eds[pkg] = ed
    assert eds["torch"].error == eds["jax"].error is not None
    assert "COMPILE ERROR" in eds["torch"].render_text(100, 24)
    ed = eds["torch"]
    ed.handle_key(_ENTER)
    ed.edit = "\tmax_particles 128"
    ed.handle_key(_ENTER)
    assert ed.error is None
    ed.handle_key(0, "s")
    ed2 = particle_editor("torch", ed.path)
    assert ed2.error is None and ed2.emitters["test"].decl.max_particles == 128
    ed2.step_preview(frames=10)
    assert len(ed2.history["test"]) == 10 and ed2.history["test"][0] >= 8
    scr = ed2.render_text(100, 24)
    assert "emitter test" in scr and "alive" in scr


def test_particle_editor_preview_equal(tmp_path):
    path = tmp_path / "sparks.pat"
    path.write_text(A.PAT_TEXT)
    r, p = particle_editor("jax", path), particle_editor("torch", path)
    assert r.error is None and p.error is None
    r.step_preview(30)
    p.step_preview(30)
    assert p.history == r.history
    assert max(p.history["sparks"]) > 8 and p.status == "previewed 30 frames"
    ref = jax_preview(r.emitters, 30)
    for name, rs in ref.items():
        ps = p.states[name]
        alive = np.asarray(rs.alive)
        np.testing.assert_array_equal(ps.alive.numpy(), alive)
        for f in ("emitted", "killed", "overflow"):
            assert int(getattr(ps, f)) == int(getattr(rs, f)), f
        np.testing.assert_allclose(ps.channels.numpy()[:, alive],
                                   np.asarray(rs.channels)[:, alive], atol=PARTICLE_ATOL, rtol=0)
    assert p.render_text(100, 24) == r.render_text(100, 24)


# -- the voxelizer ------------------------------------------------------------------------

def test_voxelizer_on_a_written_fbx(tmp_path):
    path = tmp_path / "rock.fbx"
    path.write_bytes(A.rock_fbx(0))
    uis = [mod(pkg, "editor.voxelizer_ui").VoxelizerUI(model_path=str(path))
           for pkg in ("jax", "torch")]
    for keys in ("", "a", "b", "]]]]]]]]]]]]]]]]", "+", "r", "b", "-"):
        for ui in uis:
            for ch in keys:
                ui.handle_key(0, ch)
        r, p = uis
        np.testing.assert_array_equal(p.grid, r.grid)
        assert (p.ao is None) == (r.ao is None)
        if r.ao is not None:
            np.testing.assert_array_equal(p.ao, r.ao)
        np.testing.assert_array_equal(p.slice_image(), r.slice_image())
        assert p.render_text(60, 16) == r.render_text(60, 16)
    assert p.resolution == 64 and p.grid.sum() > 100 and p.show_ao
    assert (p.slice_image() > 0).any()
