"""The port's navigation, GUI, audio and core (spline, signal) modules against
the JAX package's, frame by frame on the scenes of tests/test_navigation.py
and tests/test_gui_audio.py, and create_full_engine's system order.

Each scene is built by both packages from one builder (the package's
classes passed in); the JAX step runs jitted (vmapped for a batch), the
port's on the CPU from the JAX state carried over by `bridge`. Tolerances:
NAV_ATOL on agent positions and velocities (float32 sums of a few hundred
frames at |x| <= 20 m; rsqrt and sqrt differ by ulps), GUI_ATOL on resolved
rects (canvas pixels, exact in both), AUDIO_ATOL on gains, pans, cursors
and mixed samples; integer and boolean fields equal. The largest error each
scene shows is printed (pytest -s)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu_torch import bridge
from test_torch_bridge import ref_to_numpy

torch.set_num_threads(1)

NAV_ATOL = 2e-4
VO_TIE = 1e-5     # VO costs this close pick by rounding (mirrored candidates tie exactly)
GUI_ATOL = 1e-4
AUDIO_ATOL = 1e-5
SPLINE_ATOL = 2e-6


def _pkg(name):
    """The two packages' modules by dotted name: (reference, port)."""
    import importlib

    return (importlib.import_module("lumixengine_tpu." + name),
            importlib.import_module("lumixengine_tpu_torch." + name))


def ref_stepper(engine, world, num_worlds=1):
    raw = engine.build_step(world, jit=False)
    fn = jax.vmap(raw, in_axes=(0, None)) if num_worlds > 1 else raw
    return jax.jit(fn)


def replicate_ref(state, num_worlds, seed=3):
    from lumixengine_tpu.parallel.mesh import replicate_state

    return replicate_state(state, num_worlds, jax.random.PRNGKey(seed))


class Pair:
    """One scene in both packages, stepped side by side from the reference's
    state. `prefixes` names the fields compared each frame; `errs` keeps the
    largest error of each float field."""

    def __init__(self, build, num_worlds=1, prefixes=("modules.", "local.pos", "world.pos"),
                 setup=None):
        (self.re, self.rw, self.rx), (self.pe, self.pw, self.px) = build(0), build(1)
        self.num_worlds = num_worlds
        self.rstep = ref_stepper(self.re, self.rw, num_worlds)
        self.pstep = self.pe.build_step(self.pw, "cpu")
        r0 = self.rw.device_state()
        ref, got = ref_to_numpy(r0), bridge.state_to_numpy(self.pw.device_state("cpu"))
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        self.rs, self.ps = r0, bridge.state_from_numpy(ref_to_numpy(r0), "cpu")
        if setup is not None:          # host edits on the single world, before the batch
            setup(self)
        if num_worlds > 1:
            self.rs = replicate_ref(self.rs, num_worlds)
            self.ps = bridge.state_from_numpy(ref_to_numpy(self.rs), "cpu")
        self.prefixes = prefixes
        self.errs = {}

    def rmod(self, name):
        return self.rw.modules[name]

    def pmod(self, name):
        return self.pw.modules[name]

    def apply(self, rfn, pfn):
        self.rs, self.ps = rfn(self.rs), pfn(self.ps)

    def step(self, dt, atol, lockstep=False):
        """One frame in both packages; with `lockstep` the port steps from
        the reference's state (one frame's error, no drift)."""
        if lockstep:
            self.ps = bridge.state_from_numpy(ref_to_numpy(self.rs), "cpu")
        self.rs = self.rstep(self.rs, jnp.float32(dt))
        self.ps = self.pstep(self.ps, dt)
        self.compare(atol)

    def compare(self, atol):
        ref, got = ref_to_numpy(self.rs), bridge.state_to_numpy(self.ps)
        for k, r in ref.items():
            if not k.startswith(self.prefixes):
                continue
            g = got[k]
            assert g.shape == r.shape and g.dtype == r.dtype, k
            if r.dtype.kind == "f":
                err = float(np.abs(g - r).max()) if r.size else 0.0
                self.errs[k] = max(self.errs.get(k, 0.0), err)
                np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(g, r, err_msg=k)

    def report(self, label):
        print(label, {k: v for k, v in self.errs.items() if v > 0})


# -- create_full_engine ---------------------------------------------------------------------

def test_full_engine_registers_the_eight_systems_in_the_reference_order():
    rapp, papp = _pkg("app")
    re_, pe = rapp.create_full_engine(model_instances=8), papp.create_full_engine(
        device="cpu", model_instances=8)
    names = [s.name for s in pe.system_manager.systems]
    assert names == [s.name for s in re_.system_manager.systems]
    assert names == ["core_system", "renderer_system", "animation_system", "physics_system",
                     "script_system", "navigation_system", "gui_system", "audio_system"]
    rw, pw = re_.create_world(capacity=8), pe.create_world(capacity=8)
    assert list(pw.modules) == list(rw.modules)
    assert sorted(pw.component_types) == sorted(rw.component_types)
    assert pe.device == torch.device("cpu")
    assert papp.create_full_engine().device.type == "cuda"   # the card by default


def test_runner_parts_not_ported_name_their_roadmap_item(tmp_path):
    """The parts this test once found not ported now run (the name dates
    from then): the terminal UI presents each frame into its output, and
    an FBX file a scene names is decoded in both packages (one that does
    not parse is the placeholder). A missing .unv is an OSError."""
    import contextlib
    import io

    from lumixengine_tpu_torch.models import asset_scenes as A

    _, papp = _pkg("app")
    _, pdemo = _pkg("models.demo_scenes")
    engine, world, _ = pdemo.headless_demo_world(num_entities=64)
    engine.device = torch.device("cpu")
    runner = papp.Runner([], engine=engine)
    runner.use_world(world)
    runner.start()
    assert runner.device == torch.device("cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        papp._run_tui(runner, 2)
    text = out.getvalue()
    assert text.count("\x1b[H") == 2 and "\x1b[?1049h" in text and "\x1b[?1049l" in text
    assert int(bridge.state_to_numpy(runner.state)["frame"]) == 2
    with pytest.raises(OSError):
        papp.Runner([], engine=papp.create_full_engine(device="cpu")).load_world(
            str(tmp_path / "x.unv"))
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "a.fbx").write_bytes(b"Kaydara FBX Binary  \0")
    (tmp_path / "models" / "b.fbx").write_bytes(A.sphere_fbx(0))
    for eng_mod, inst_mod in zip(_pkg("app"), _pkg("importers.instantiate")):
        eng = (eng_mod.create_full_engine(device="cpu") if eng_mod is papp
               else eng_mod.create_full_engine())
        renderer = eng.system_manager.get_system("renderer_system")
        assets = inst_mod.SceneAssets(renderer, data_dirs=(str(tmp_path),))
        a, b = assets.model_id("models/a.fbx"), assets.model_id("models/b.fbx")
        assert assets.model_id("models/absent.fbx") >= 0
        assert dict(assets.report) == {"model_placeholder": 2, "model_fbx": 1}
        assert renderer.models.get(b).vertex_positions.shape == (482, 3) and a != b


# -- navigation -------------------------------------------------------------------------------

def _nav_engine(side, caps, capacity):
    eng_mod, nav_mod = _pkg("engine.engine")[side], _pkg("navigation.module")[side]
    engine = eng_mod.Engine()
    engine.module_capacities = caps
    engine.add_system(nav_mod.NavigationSystem(engine))
    return engine, engine.create_world(capacity=capacity), nav_mod


def _walkers(side):
    engine, world, nav_mod = _nav_engine(side, {"nav_agents": 8}, 8)
    a = world.create_entity(position=(2.0, 0.0, 2.0))
    b = world.create_entity(position=(4.0, 0.0, 2.0))
    world.create_component(a, "nav_agent", speed=3.0)
    world.create_component(b, "nav_agent", speed=3.0)
    world.modules["navigation"].zone = nav_mod.NavZone(origin=(0, 0), size=(32, 32), cell=1.0)
    return engine, world, (a, b)


def test_agents_walk_to_destination_frame_by_frame():
    p = Pair(_walkers)
    (a, b) = p.px
    p.apply(lambda s: p.rmod("navigation").set_destination(s, a, (20.0, 20.0)),
            lambda s: p.pmod("navigation").set_destination(s, a, (20.0, 20.0)))
    p.compare(NAV_ATOL)
    assert int(p.ps.modules["navigation"].wp_count[p.pmod("navigation").agents.slot_of(a)]) >= 2
    for _ in range(320):
        p.step(1 / 30, NAV_ATOL)
    p.report("walk")
    nav = p.pmod("navigation")
    pa = p.ps.modules["navigation"].agent_pos[:, nav.agents.slot_of(a)].numpy()
    assert abs(pa[0] - 20.0) < 1.0 and abs(pa[2] - 20.0) < 1.0
    np.testing.assert_allclose(p.ps.world.pos[:, p.pw.slot(a)].numpy(), pa, atol=1e-4)


def _crowd(side, threshold, window=31, n=24, seed=11):
    engine, world, _ = _nav_engine(side, {"nav_agents": 32}, 64)
    nm = world.modules["navigation"]
    nm.separation_window_threshold = threshold
    nm.separation_window = window
    rng = np.random.default_rng(seed)
    for _ in range(n):
        q = rng.uniform(-3, 3, 2)
        e = world.create_entity(position=(q[0], 0.0, q[1]))
        world.create_component(e, "nav_agent", radius=0.5)
    return engine, world, None


@pytest.mark.parametrize("regime,threshold", [("dense", 1000), ("windowed", 1)])
def test_separation_frame_by_frame(regime, threshold):
    """The dense and the x-sorted window separation (plus the VO pass of
    idle agents), each against the reference's, and the two regimes
    against each other (window covering every pair), as the JAX test holds."""
    p = Pair(lambda side: _crowd(side, threshold))
    for _ in range(30):
        p.step(1 / 30, NAV_ATOL)
    p.report(regime)
    q = Pair(lambda side: _crowd(side, 1000 if threshold == 1 else 1))
    for _ in range(30):
        q.step(1 / 30, NAV_ATOL)
    np.testing.assert_allclose(p.ps.modules["navigation"].agent_pos.numpy(),
                               q.ps.modules["navigation"].agent_pos.numpy(), atol=1e-4)


def test_windowed_separation_on_a_world_batch():
    """W=3 worlds (the reference's perturbation), windowed regime with a
    window shorter than the crowd: the port's batch axis against the vmap."""
    p = Pair(lambda side: _crowd(side, 1, window=6), num_worlds=3)
    for _ in range(20):
        p.step(1 / 30, NAV_ATOL)
    p.report("windowed W=3")


def head_on_streams(side, threshold=256, lines=3):
    """tests/test_navigation.py's head-on streams: two opposing lines."""
    engine, world, nav_mod = _nav_engine(side, {"nav_agents": 8}, 16)
    nav = world.modules["navigation"]
    nav.separation_window_threshold = threshold
    nav.separation_window = 7           # below the 8 agent slots (covers them all)
    nav.zone = nav_mod.NavZone(origin=(-20, -20), size=(40, 40), cell=1.0)
    ents = []
    for i in range(lines):
        a = world.create_entity(position=(-8.0, 0.0, -1.0 + 1.0 * i))
        b = world.create_entity(position=(8.0, 0.0, -0.9 + 1.0 * i))
        world.create_component(a, "nav_agent", radius=0.4, speed=3.0)
        world.create_component(b, "nav_agent", radius=0.4, speed=3.0)
        ents += [a, b]
    return engine, world, ents


def stream_targets(ents):
    return [(e, (8.0, -1.0 + (i // 2)) if i % 2 == 0 else (-8.0, -0.9 + (i // 2)))
            for i, e in enumerate(ents)]


def check_streams(nav, state, slots_pos_log, ents):
    """The JAX test's gate: no two centres closer than 0.5 (radii 0.4 + 0.4)
    on any logged frame, and everyone within 2 m of the far side's x."""
    min_gap = np.inf
    for xz in slots_pos_log:
        d = xz[:, :, None] - xz[:, None, :]
        dist = np.sqrt((d ** 2).sum(axis=0)) + np.eye(xz.shape[1]) * 1e9
        min_gap = min(min_gap, float(dist.min()))
    p = state.modules["navigation"].agent_pos.detach().cpu().numpy()[
        :, [nav.agents.slot_of(e) for e in ents]]
    arrived = all(abs(p[0, i] - (8.0 if i % 2 == 0 else -8.0)) < 2.0 for i in range(len(ents)))
    return min_gap, arrived


def step_vo_explained(p, dt, atol):
    """One lockstep frame of a navigation scene. Where it breaks, every agent
    whose VO pick differs from the reference's must sit at a tie (the two
    candidates' costs, the port's, within VO_TIE), and with the reference's
    picks at those ties the port's frame must hold at `atol`. Returns the
    number of agents picked at a tie."""
    before, errs = p.rs, dict(p.errs)
    try:
        p.step(dt, atol, lockstep=True)
        return 0
    except AssertionError:
        p.errs = errs
    nav = p.pmod("navigation")
    ps0 = bridge.state_from_numpy(ref_to_numpy(before), "cpu")
    d = nav._device_statics(torch.device("cpu"))
    ns0 = ps0.modules["navigation"]
    _, _, pos_xz, des = nav._steering(d, ns0)
    cands, cost = nav._vo_cost(d, pos_xz, des, ns0.agent_vel, d["mask"])
    ref_vel = torch.as_tensor(np.array(p.rs.modules["navigation"].agent_vel))
    ref_pick = ((cands - ref_vel[..., None, :, :]) ** 2).sum(-2).argmin(-2)
    port_pick = cost.argmin(-2)
    flipped = (ref_pick != port_pick) & d["mask"]
    assert bool(flipped.any()), "the frame breaks with equal VO picks"
    gap = (cost.gather(-2, ref_pick[..., None, :]) - cost.gather(-2, port_pick[..., None, :]))
    assert float(gap.abs()[..., 0, :][flipped].max()) <= VO_TIE

    def forced(d_, pos_, des_, nvel_, mask_):
        pick = torch.where(flipped, ref_pick, port_pick)
        chosen = torch.gather(cands, -3, pick[..., None, None, :].expand(
            cands.shape[:-3] + (1,) + cands.shape[-2:]))[..., 0, :, :]
        return torch.where(mask_[..., None, :], chosen, des_)

    nav._sample_velocity = forced
    try:
        p.ps = p.pstep(ps0, dt)
    finally:
        del nav._sample_velocity
    p.compare(atol)
    return int(flipped.sum())


@pytest.mark.parametrize("regime,threshold", [("dense", 256), ("windowed", 4)])
def test_velocity_obstacle_head_on_streams(regime, threshold):
    """520 frames of the head-on streams (dense VO, and the windowed VO with
    a window covering the 6 agents): frame by frame in lockstep against the
    reference, VO picks at ties explained (step_vo_explained); then the port
    alone from the same start, held to the JAX test's gate."""
    p = Pair(lambda side: head_on_streams(side, threshold))
    ents = p.px
    for e, tgt in stream_targets(ents):
        p.apply(lambda s, e=e, t=tgt: p.rmod("navigation").set_destination(s, e, t),
                lambda s, e=e, t=tgt: p.pmod("navigation").set_destination(s, e, t))
    free = p.ps
    ties = [step_vo_explained(p, 1 / 60, NAV_ATOL) for _ in range(520)]
    p.report(f"streams {regime}")
    print(f"streams {regime}: agents picked at VO ties in {sum(t > 0 for t in ties)} of 520 frames")
    nav = p.pmod("navigation")
    slots = [nav.agents.slot_of(e) for e in ents]
    log = []
    for f in range(520):
        free = p.pstep(free, 1 / 60)
        if f % 5 == 0:
            log.append(free.modules["navigation"].agent_pos.numpy()[[0, 2]][:, slots])
    min_gap, arrived = check_streams(nav, free, log, ents)
    print(f"streams {regime}: port alone, min gap {min_gap:.4f}, arrived {arrived}")
    assert min_gap > 0.5, min_gap
    assert arrived


def test_set_destination_fills_every_world_and_astar_matches():
    rnav, pnav = _pkg("navigation.module")
    rz, pz = (m.NavZone(origin=(0, 0), size=(16, 16), cell=1.0) for m in (rnav, pnav))
    for z in (rz, pz):
        z.walkable[0:12, 6] = False
    np.testing.assert_array_equal(pz.find_path((1.5, 1.5), (10.5, 1.5)),
                                  rz.find_path((1.5, 1.5), (10.5, 1.5)))
    z2 = pnav.NavZone(size=(8, 8))
    z2.walkable[:, 4] = False
    assert z2.find_path((1.0, 1.0), (6.0, 1.0)) is None
    def dest(p):
        a = p.px[0]
        p.apply(lambda s: p.rmod("navigation").set_destination(s, a, (20.0, 20.0)),
                lambda s: p.pmod("navigation").set_destination(s, a, (20.0, 20.0)))

    p = Pair(_walkers, num_worlds=3, setup=dest)
    for _ in range(10):
        p.step(1 / 30, NAV_ATOL)
    # the port's set_destination on a batch writes the path into every world
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    a = p.px[0]
    nav = p.pmod("navigation")
    one = nav.set_destination(p.pw.device_state("cpu"), a, (20.0, 20.0)).modules["navigation"]
    many = nav.set_destination(replicate_state(p.pw.device_state("cpu"), 3), a,
                               (20.0, 20.0)).modules["navigation"]
    slot = nav.agents.slot_of(a)
    assert int(one.wp_count[slot]) >= 2
    for w in range(3):
        assert int(many.wp_count[w, slot]) == int(one.wp_count[slot])
        assert torch.equal(many.waypoints[w], one.waypoints)


def test_shipped_navmesh_import_raises(tmp_path):
    """A nav_zone with a guid no longer raises: it loads navzones/<guid>.nav
    from its nav_dirs (the packed zone here, equal to the JAX module's
    grid), and keeps the all-walkable default where no file is found."""
    from lumixengine_tpu_torch.models import host_scenes as H

    guid = 7470683995146639429
    d = tmp_path / "navzones"
    d.mkdir()
    (d / f"{guid}.nav").write_bytes(H.nav_blob(H.ring_zone_polys(8.0, 2.0),
                                               origin=(-8.0, 0.0, -8.0)))
    zones = []
    for side in (0, 1):
        engine, world, _ = _nav_engine(side, {"nav_agents": 8}, 8)
        e = world.create_entity()
        world.create_component(e, "nav_zone", origin=(-8.0, -8.0), size=(16.0, 16.0), cell=0.5,
                               guid=guid, nav_dirs=(str(tmp_path),))
        zones.append(world.modules["navigation"].zone)
        e2 = world.create_entity()
        world.create_component(e2, "nav_zone", guid=guid + 1, nav_dirs=(str(tmp_path),))
        assert not world.modules["navigation"].zone.from_navmesh
        assert world.modules["navigation"].zone.walkable.all()
    assert zones[1].from_navmesh and 0 < zones[1].walkable.mean() < 1
    np.testing.assert_array_equal(zones[1].walkable, zones[0].walkable)


# -- GUI --------------------------------------------------------------------------------------

def _gui(side, with_core=False):
    eng_mod, gui_mod = _pkg("engine.engine")[side], _pkg("gui.module")[side]
    engine = eng_mod.Engine()
    engine.add_system(gui_mod.GuiSystem(engine))
    if with_core:
        engine.add_system(_pkg("engine.core_module")[side].CoreSystem(engine))
    world = engine.create_world(capacity=16)
    world.modules["gui"].canvas_size = (1000, 500)
    return engine, world


def _nested(side):
    engine, world = _gui(side)
    panel = world.create_entity()
    world.create_component(panel, "gui_rect", anchor=(0.25, 0.25, 0.75, 0.75))
    child = world.create_entity()
    world.set_parent(child, panel)
    world.create_component(child, "gui_rect", anchor=(0.5, 0.0, 1.0, 1.0),
                           offset=(10, 10, -10, -10))
    grand = world.create_entity()
    world.set_parent(grand, child)
    world.create_component(grand, "gui_rect", anchor=(0.0, 0.5, 0.5, 1.0), offset=(2, 3, -4, -5))
    b = world.create_entity()
    world.create_component(b, "gui_rect", anchor=(0, 0, 0, 0), offset=(100, 100, 200, 150))
    world.create_component(b, "gui_button")
    return engine, world, (panel, child, grand, b)


@pytest.mark.parametrize("num_worlds", [1, 2])
def test_gui_nested_anchors_hover_and_click(num_worlds):
    p = Pair(_nested, num_worlds=num_worlds)
    panel, child, grand, b = p.px
    gm, rgm = p.pmod("gui"), p.rmod("gui")
    pointer = [(50, 50, False), (150, 120, False), (150, 120, True), (150, 120, True),
               (600, 300, False), (600, 300, True)]
    clicks = []
    def ref_inject(s, x, y, down):
        """The reference's inject_pointer writes one world's pointer; a
        batch gets it in every world."""
        s = rgm.inject_pointer(s, x, y, down)
        if num_worlds == 1:
            return s
        g = s.modules["gui"]
        g = g.replace(pointer=jnp.broadcast_to(g.pointer, (num_worlds, 2)),
                      pointer_down=jnp.broadcast_to(g.pointer_down, (num_worlds,)))
        return s.replace(modules={**s.modules, "gui": g})

    for x, y, down in pointer:
        p.apply(lambda s: ref_inject(s, x, y, down),
                lambda s: gm.inject_pointer(s, x, y, down))
        p.step(1 / 60, GUI_ATOL)
        clicks.append(gm.clicked_entities(p.ps))
        ref_clicked = np.asarray(p.rs.modules["gui"].clicked).reshape(-1, gm.rects.capacity)[0]
        assert clicks[-1] == [int(rgm.rects.entity[k]) for k in np.nonzero(ref_clicked)[0]]
    p.report(f"gui W={num_worlds}")
    r = p.ps.modules["gui"].resolved.numpy().reshape(-1, 4, gm.rects.capacity)[0]
    np.testing.assert_allclose(r[:, gm.rects.slot_of(panel)], [250, 125, 750, 375], atol=1e-4)
    np.testing.assert_allclose(r[:, gm.rects.slot_of(child)], [510, 135, 740, 365], atol=1e-4)
    assert clicks == [[], [], [b], [], [], []]


def test_gui_draw_list_and_input_field_match_reference():
    from lumixengine_tpu.engine import input as rinp
    from lumixengine_tpu_torch.engine import input as pinp

    def build(side):
        engine, world = _gui(side)
        e = world.create_entity()
        world.create_component(e, "gui_rect", anchor=(0, 0, 0, 0), offset=(100, 100, 500, 200))
        world.create_component(e, "gui_image", color=(1, 0, 0, 1))
        world.create_component(e, "gui_text", text="Hello", font_size=24, align_h=1, align_v=1)
        f = world.create_entity()
        world.create_component(f, "gui_rect", anchor=(0, 0, 0, 0), offset=(100, 300, 400, 340))
        world.create_component(f, "gui_input_field", text="abc", font_size=20)
        return engine, world, (e, f)

    p = Pair(build)
    e, f = p.px
    gm, rgm = p.pmod("gui"), p.rmod("gui")
    p.apply(lambda s: rgm.inject_pointer(s, 101.0, 320.0, True),
            lambda s: gm.inject_pointer(s, 101.0, 320.0, True))
    p.step(1 / 60, GUI_ATOL)
    for side, (mod, inp, state) in enumerate(((rgm, rinp, p.rs), (gm, pinp, p.ps))):
        isys = inp.InputSystem()
        isys.update()
        mod.process_input(state, isys)
        isys.inject_text("X")
        isys.inject_button(inp.DEVICE_KEYBOARD, inp.KEY_END, True)
        isys.inject_text("!")
        isys.update()
        mod.process_input(state, isys)
    assert gm.focused == rgm.focused == f
    assert gm.input_fields[f] == rgm.input_fields[f]
    assert gm.input_fields[f]["text"] == "Xabc!"
    got, ref = gm.draw_list(p.ps), rgm.draw_list(p.rs)
    assert got == ref
    assert got[0]["text"] == "Hello" and got[0]["color"] == [1, 0, 0, 1]


def test_gui_text_lays_out_on_a_host_without_the_default_font(monkeypatch, tmp_path):
    """The GUI's text asks for the default face. Where DEFAULT_FONT is
    installed that is DejaVu Sans (the reference's face); on a host without
    it the port takes the FreeType face PIL ships, so a GUI world still
    presents there. An explicit path that does not exist still raises."""
    from lumixengine_tpu_torch.renderer import font

    assert font.FontSystem().load(size=24).path == font.DEFAULT_FONT
    monkeypatch.setattr(font, "DEFAULT_FONT", str(tmp_path / "absent.ttf"))
    f = font.FontSystem().load(size=24)
    assert f.path is None and f.line_height > 0
    w, h = f.text_extents("Hello")
    assert w > 0 and h > 0 and f.rasterize_text("Hello").max() > 0
    with pytest.raises(OSError):
        font.Font(str(tmp_path / "absent.ttf"), 24)


SIGNAL_LUA = """
hits = 0
function onSignal()
    hits = hits + 1
end
"""


def test_button_pumps_core_signal_into_a_script():
    """gui buttonClicked → the core module's Signal → the script module's
    reflected "call" → onSignal() in the button's Lua script, in both
    packages, through each package's create_full_engine."""
    out = []
    for side in (0, 1):
        app = _pkg("app")[side]
        engine = (app.create_full_engine(model_instances=8) if side == 0 else
                  app.create_full_engine(device="cpu", model_instances=8))
        world = engine.create_world(capacity=16)
        gm = world.modules["gui"]
        gm.canvas_size = (1000, 500)
        b = world.create_entity(name="button")
        world.create_component(b, "gui_rect", anchor=(0, 0, 0, 0), offset=(100, 100, 200, 150))
        world.create_component(b, "gui_button")
        world.create_component(b, "signal", event_component="gui", event="buttonClicked",
                               function_component="script", function="call", target_entity=b)
        env = world.modules["script"].attach_lua_script(b, source=SIGNAL_LUA)
        runner = app.Runner([], engine=engine)
        runner.use_world(world)
        runner.start()
        counts = []
        for down in (False, True, True, False, True):
            runner.state = gm.inject_pointer(runner.state, 150, 120, down)
            runner.tick()
            counts.append(env.env.get("hits"))
        out.append(counts)
    assert out[1] == out[0] == [0, 1, 1, 1, 2]


# -- audio ------------------------------------------------------------------------------------

def _audio(side, clip="hum", seconds=0.1, rate=22050):
    eng_mod, au = _pkg("engine.engine")[side], _pkg("audio.module")[side]
    engine = eng_mod.Engine()
    asys = au.AudioSystem(engine)
    asys.add_clip(au.AudioClip.sine(clip, freq=220.0, seconds=seconds, rate=rate))
    engine.add_system(asys)
    return engine, engine.create_world(capacity=16)


def _audio_scene(side):
    engine, world = _audio(side)
    lis = world.create_entity(position=(0, 0, 0), rotation=(0.0, 0.3826834, 0.0, 0.9238795))
    world.create_component(lis, "listener")
    near = world.create_entity(position=(1.0, 0, 0.5))
    far = world.create_entity(position=(15.0, 0, -3.0))
    out = world.create_entity(position=(100.0, 0, 0))
    flat = world.create_entity(position=(-2.0, 1.0, 0))
    for e in (near, far, out):
        world.create_component(e, "ambient_sound", clip="hum", range=20.0)
    world.create_component(flat, "ambient_sound", clip="hum", is_3d=False, volume=0.5)
    quiet = world.create_entity(position=(0.5, 0, 0))
    world.create_component(quiet, "ambient_sound", clip="hum", autoplay=False, range=10.0)
    z = world.create_entity(position=(0.5, 0, 0))
    world.create_component(z, "echo_zone", radius=5.0, wetness=0.7)
    z2 = world.create_entity(position=(3.0, 0, 0))
    world.create_component(z2, "echo_zone", radius=5.0, wetness=0.3, delay_ms=80.0)
    c = world.create_entity(position=(0, 0, 0))
    world.create_component(c, "chorus_zone", radius=5.0, wetness=0.4, delay_ms=15.0)
    return engine, world, (near, far, out, flat, quiet)


@pytest.mark.parametrize("num_worlds", [1, 3])
def test_audio_positioning_zones_play_stop_and_mix(num_worlds):
    p = Pair(_audio_scene, num_worlds=num_worlds)
    near, far, out, flat, quiet = p.px
    am, ram = p.pmod("audio"), p.rmod("audio")
    for _ in range(3):
        p.step(1 / 60, AUDIO_ATOL)
    p.apply(lambda s: ram.play(s, quiet), lambda s: am.play(s, quiet))
    p.step(1 / 60, AUDIO_ATOL)
    p.apply(lambda s: ram.stop(s, near), lambda s: am.stop(s, near))
    p.step(1 / 60, AUDIO_ATOL)
    p.report(f"audio W={num_worlds}")
    ms = p.ps.modules["audio"]
    g = ms.gain.numpy().reshape(-1, am.sounds.capacity)[0]
    sn, sf, so, sq = (am.sounds.slot_of(e) for e in (near, far, out, quiet))
    assert g[sf] > 0.0 and g[so] == 0.0 and g[sq] > 0.5 and g[sn] == 0.0
    assert float(ms.echo_mix.reshape(-1)[0]) == pytest.approx(0.7, abs=1e-6)
    assert float(ms.chorus_mix.reshape(-1)[0]) == pytest.approx(0.4, abs=1e-6)
    if num_worlds == 1:
        rms = p.rs.modules["audio"]
        for frames, kw in ((256, {}), (128, {"echo_mix": 0.8, "echo_delay": 500.0}),
                           (200, {"chorus_mix": 0.6, "chorus_delay": 700.0})):
            ref = np.asarray(ram.mix_block(rms.replace(**{k: jnp.float32(v) for k, v in kw.items()}),
                                           frames=frames))
            got = am.mix_block(ms.replace(**{k: torch.tensor(v) for k, v in kw.items()}),
                               frames=frames).numpy()
            assert got.shape == ref.shape == (2, frames)
            np.testing.assert_allclose(got, ref, atol=AUDIO_ATOL, rtol=0)
            assert np.abs(got).max() > 0.01
    else:
        got = am.mix_block(ms, frames=64).numpy()
        assert got.shape == (num_worlds, 2, 64)
        for w in range(num_worlds):
            one = am.mix_block(ms.replace(**{f: getattr(ms, f)[w] for f in (
                "playing", "cursor", "gain", "pan", "echo_mix", "echo_delay", "chorus_mix",
                "chorus_delay")}), frames=64).numpy()
            np.testing.assert_array_equal(got[w], one)


def test_audio_device_consumes_port_blocks():
    _, au = _pkg("audio.module")
    p = Pair(_audio_scene)
    p.step(1 / 60, AUDIO_ATOL)
    am, ms = p.pmod("audio"), p.ps.modules["audio"]
    dev = au.AudioDevice(frames_per_block=128)
    dev.pump(lambda n: am.mix_block(ms, frames=n), blocks=4)
    assert len(dev.blocks) == 4 and dev.blocks[0].shape == (2, 128)
    blob = dev.wav()
    assert blob[:4] == b"RIFF" and len(blob) > 4 * 128 * 4


# -- splines ------------------------------------------------------------------------------------

def test_sample_spline_at_ends_joints_and_between():
    rcm, pcm = _pkg("engine.core_module")

    def build(side):
        eng_mod = _pkg("engine.engine")[side]
        engine = eng_mod.Engine()
        engine.add_system((rcm, pcm)[side].CoreSystem(engine))
        world = engine.create_world(capacity=8)
        pts = [[(0, 0, 0), (1, 0, 0), (1, 2, 0), (4, 2, 1)],
               [(0, 1, 0), (0, 1, 5)],
               [(2, 2, 2)],
               [(0, 0, 0), (0, 0, 0), (3, 0, 0)]]
        for p in pts:
            e = world.create_entity()
            world.create_component(e, "spline", points=p)
        return world.modules["core"]

    rmod, pmod = build(0), build(1)
    pmod.prepare_statics("cpu")
    rb, pb = rmod.bank, pmod.bank
    ref_tree = ref_to_numpy(rb)
    for k, v in bridge.state_to_numpy(pb).items():
        np.testing.assert_array_equal(v, ref_tree[k], err_msg=k)
    carried = bridge.spline_bank_from_numpy(ref_tree, "cpu")
    seg = ref_tree["seg_len"][:, 0]
    joints = np.cumsum(seg)[:-1] / seg.sum()                   # t at the joints of spline 0
    ts = np.concatenate([[0.0, 1.0, -0.5, 1.5], joints, joints - 1e-3, joints + 1e-3,
                         np.linspace(0.05, 0.95, 7)]).astype(np.float32)
    worst = 0.0
    for s in range(4):
        idx = np.full(ts.shape, s, np.int32)
        ref = np.asarray(rcm.sample_spline(rb, jnp.asarray(idx), jnp.asarray(ts)))
        got = pcm.sample_spline(carried, torch.as_tensor(idx), torch.as_tensor(ts)).numpy()
        assert got.shape == ref.shape == (3, ts.size)
        np.testing.assert_allclose(got, ref, atol=SPLINE_ATOL, rtol=0)
        worst = max(worst, float(np.abs(got - ref).max()))
    print("spline max abs err", worst)
    got = pcm.sample_spline(pb, torch.tensor([0, 0, 0]), torch.tensor([0.0, float(joints[0]), 1.0]))
    np.testing.assert_allclose(got.numpy().T, [(0, 0, 0), (1, 0, 0), (4, 2, 1)], atol=1e-5)


# -- the game world (models/game_scenes.py) -----------------------------------------------------

def test_game_world_through_the_runner_holds_the_gates():
    """chip_smoke.py's game world on the CPU: the head-on streams, the two
    scripts, the GUI button wired to a script, the 3D sound with an echo
    zone and a spline, through Runner.tick for the streams' 520 frames, held
    to the JAX tests' gates (game_scenes.check_game)."""
    from lumixengine_tpu_torch import app
    from lumixengine_tpu_torch.models import game_scenes as G

    engine, world, h = G.game_world("cpu")
    runner = app.Runner([], engine=engine)
    runner.use_world(world)
    gaps, xs, clicks = G.run_game(runner, h)
    sm = world.modules["script"]
    assert [g.entities for g in sm._fast_groups] == [[h["pinger"]]]   # the branchy script only
    out = G.check_game(runner, h, gaps, xs, clicks)
    print("game world:", out)
    assert runner.metrics()["frame"] == G.STREAM_FRAMES


def test_crossing_streams_take_the_windowed_regime():
    """The width path's world (chip_smoke.py phase c): 2 x 512 crossing
    agents, above the dense threshold, so the x-sorted window regime runs;
    3 frames at W=2, finite, every agent navigating, no overlap. (The window
    regime is held to the reference in test_separation_frame_by_frame and
    test_velocity_obstacle_head_on_streams.)"""
    from lumixengine_tpu_torch.models import game_scenes as G

    engine, world, h = G.game_world("cpu", crossing=512)
    nav = world.modules["navigation"]
    assert nav.agents.capacity == 1024 > nav.separation_window_threshold
    assert len(nav.agents) == 1024
    step = engine.build_step(world, "cpu")
    engine.start_game(world)
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    state = replicate_state(G.start_navigation(world.device_state("cpu"), world, h), 2,
                            torch.Generator().manual_seed(0))
    for _ in range(3):
        state = step(state, 1 / 60)
    ns = state.modules["navigation"]
    assert bool(torch.isfinite(ns.agent_pos).all())
    assert ns.counters["navigating"].tolist() == [1024, 1024]
    assert G.min_gap(state, world, h) > G.MIN_GAP
