"""A small game world for the full engine: the scenes of the JAX package's
script, navigation, GUI and audio tests in one world, built through
``app.create_full_engine`` and run by the ``Runner``.

* scripts: the branchy ping-pong script (compiles to the device fast path)
  and one that stays on the host interpreter (tests/test_lua_fastpath.py);
* navigation: the head-on agent streams, three a side
  (tests/test_navigation.py), or, with ``crossing``, two crossing streams of
  ``crossing`` agents each, enough for the x-sorted window regime;
* GUI: a panel with nested anchors and a button whose click is wired by a
  core Signal to the script module's "call", which runs ``onSignal()`` in
  the button's Lua script (tests/test_gui_audio.py);
* audio: a listener, a 3D sound on a clip and an echo zone;
* core: a spline.

``check_game`` holds the JAX tests' gates on a finished run.
"""
from __future__ import annotations

import numpy as np

BRANCH_LUA = """
local t = 0
local dir = 1

function update(dt)
    t = t + dt * dir
    if t > 0.5 then
        dir = -1
    elseif t < -0.5 then
        dir = 1
    end
    this.position = {t, 2.0, 0.0}
end
"""

HOST_ONLY_LUA = """
local t = 0
function update(dt)
    t = t + dt
    this.name = "renamed"   -- engine API: not in the fast subset
end
"""

BUTTON_LUA = """
hits = 0
function onSignal()
    hits = hits + 1
end
"""

CANVAS = (1000, 500)
BUTTON_PIXEL = (150, 120)      # inside the button's rect
STREAM_FRAMES = 520            # tests/test_navigation.py's head-on streams
MIN_GAP = 0.5                  # that test's bound on the closest centres (radii 0.4 + 0.4)
ARRIVE = 2.0                   # and on the distance to the far side's x
PING_PONG = 0.55               # tests/test_lua_fastpath.py's band on the branchy script


def _streams(world, crossing: int):
    """Agent entities and their targets: the head-on streams, or two blocks
    of `crossing` agents, 1.5 m apart in 16 rows, headed across each other
    (A along +x, B along +z, 150 m each). Each block keeps 16 agents in any
    x-slab of its 1.5 m pitch, inside the x-sorted separation window (24)."""
    out = []
    if not crossing:
        for i in range(3):
            a = world.create_entity(position=(-8.0, 0.0, -1.0 + 1.0 * i))
            b = world.create_entity(position=(8.0, 0.0, -0.9 + 1.0 * i))
            for e in (a, b):
                world.create_component(e, "nav_agent", radius=0.4, speed=3.0)
            out += [(a, (8.0, -1.0 + i)), (b, (-8.0, -0.9 + i))]
        return out
    rows, pitch = 16, 1.5
    for k in range(crossing):
        c, r = divmod(k, rows)             # c along the block's way, r across it
        across = (r - (rows - 1) / 2) * pitch
        a = world.create_entity(position=(-99.0 + c * pitch, 0.0, across))
        b = world.create_entity(position=((c - (crossing // rows - 1) / 2) * pitch, 0.0,
                                          -99.0 + r * pitch))
        for e in (a, b):
            world.create_component(e, "nav_agent", radius=0.4, speed=3.0)
        ax, bz = -99.0 + c * pitch + 150.0, -99.0 + r * pitch + 150.0
        out += [(a, (ax, across)), (b, ((c - (crossing // rows - 1) / 2) * pitch, bz))]
    return out


def game_world(device="cuda", crossing: int = 0):
    """(engine, world, handles): handles names the entities the checks read
    and `targets`, the agents' destinations, set by `start_navigation`."""
    from lumixengine_tpu_torch import app
    from lumixengine_tpu_torch.audio.module import AudioClip
    from lumixengine_tpu_torch.navigation.module import NavZone

    agents = 2 * crossing if crossing else 8
    engine = app.create_full_engine(device=device, model_instances=16, nav_agents=agents)
    engine.system_manager.get_system("audio_system").add_clip(
        AudioClip.sine("hum", freq=220.0, seconds=0.1))
    world = engine.create_world(capacity=agents + 32)
    sm = world.modules["script"]
    h = {}
    h["pinger"] = world.create_entity(position=(0.0, 2.0, 0.0), name="pinger")
    sm.attach_lua_script(h["pinger"], source=BRANCH_LUA)
    h["hosted"] = world.create_entity(position=(0.0, 3.0, 0.0), name="hosted")
    sm.attach_lua_script(h["hosted"], source=HOST_ONLY_LUA)

    nav = world.modules["navigation"]
    size = 200.0 if crossing else 40.0
    nav.zone = NavZone(origin=(-size / 2, -size / 2), size=(size, size), cell=1.0)
    h["targets"] = _streams(world, crossing)

    world.modules["gui"].canvas_size = CANVAS
    panel = world.create_entity(name="panel")
    world.create_component(panel, "gui_rect", anchor=(0.25, 0.25, 0.75, 0.75))
    child = world.create_entity(name="panel_child")
    world.set_parent(child, panel)
    world.create_component(child, "gui_rect", anchor=(0.5, 0.0, 1.0, 1.0),
                           offset=(10, 10, -10, -10))
    button = world.create_entity(name="button")
    world.create_component(button, "gui_rect", anchor=(0, 0, 0, 0), offset=(100, 100, 200, 150))
    world.create_component(button, "gui_button")
    world.create_component(button, "signal", event_component="gui", event="buttonClicked",
                           function_component="script", function="call", target_entity=button)
    h["button_env"] = sm.attach_lua_script(button, source=BUTTON_LUA)
    h.update(panel=panel, child=child, button=button)

    lis = world.create_entity(position=(0.0, 0.0, 0.0), name="listener")
    world.create_component(lis, "listener")
    snd = world.create_entity(position=(1.0, 0.0, 0.0), name="sound")
    world.create_component(snd, "ambient_sound", clip="hum", range=20.0)
    echo = world.create_entity(position=(0.0, 0.0, 0.0), name="echo")
    world.create_component(echo, "echo_zone", radius=5.0, wetness=0.7)
    spline = world.create_entity(name="spline")
    world.create_component(spline, "spline", points=[(0, 0, 0), (4, 0, 0), (4, 0, 3)])
    h.update(listener=lis, sound=snd, spline=spline)
    return engine, world, h


def start_navigation(state, world, handles):
    """Each agent's path to its target (host A*), in every world of `state`."""
    nav = world.modules["navigation"]
    for e, tgt in handles["targets"]:
        state = nav.set_destination(state, e, tgt)
    return state


def min_gap(state, world, handles) -> float:
    """The closest two agents' centres (xz) in `state`, over its worlds."""
    nav = world.modules["navigation"]
    slots = [nav.agents.slot_of(e) for e, _ in handles["targets"]]
    p = state.modules["navigation"].agent_pos.detach().cpu().numpy()
    xz = p.reshape(-1, 3, p.shape[-1])[:, [0, 2]][:, :, slots]          # [W, 2, A]
    d = xz[:, :, :, None] - xz[:, :, None, :]
    dist = np.sqrt((d ** 2).sum(axis=1)) + np.eye(len(slots)) * 1e9
    return float(dist.min())


def check_game(runner, handles, gaps, xs, clicks) -> dict:
    """The JAX tests' gates on a finished Runner run of the head-on world:
    every logged gap above MIN_GAP and every agent within ARRIVE of the far
    side; the branchy script inside ±PING_PONG and really ping-ponging; the
    host script ran; the one click fired the signal once; the 3D sound is
    audible and pans right, the echo zone's wetness reached the listener;
    the spline's ends. Raises AssertionError; returns the readings."""
    import torch

    from lumixengine_tpu_torch.engine.core_module import sample_spline

    world, state = runner.world, runner.state
    nav = world.modules["navigation"]
    p = state.modules["navigation"].agent_pos.detach().cpu().numpy()
    far = [abs(p[0, nav.agents.slot_of(e)] - tx) for e, (tx, _tz) in handles["targets"]]
    am = world.modules["audio"]
    ms = state.modules["audio"]
    slot = am.sounds.slot_of(handles["sound"])
    core = world.modules["core"]
    ends = sample_spline(core.bank, torch.tensor([core.spline_index(handles["spline"])] * 2),
                         torch.tensor([0.0, 1.0], device=core.bank.points.device))
    out = {"min_gap": min(gaps), "farthest_from_target": max(far), "ping_pong": (min(xs), max(xs)),
           "hosted_name": world.names[handles["hosted"]], "signal_hits": handles["button_env"].env.get(
               "hits"), "clicks": clicks, "gain": float(ms.gain[slot]), "pan": float(ms.pan[slot]),
           "echo_mix": float(ms.echo_mix), "spline_ends": ends.T.cpu().tolist()}
    assert out["min_gap"] > MIN_GAP, out
    assert out["farthest_from_target"] < ARRIVE, out
    assert -PING_PONG <= out["ping_pong"][0] and out["ping_pong"][1] <= PING_PONG, out
    assert out["ping_pong"][0] < -0.45 and out["ping_pong"][1] > 0.45, out
    assert out["hosted_name"] == "renamed", out
    assert out["signal_hits"] == 1 and out["clicks"] == 1, out
    assert out["gain"] > 0.5 and out["pan"] > 0.9 and abs(out["echo_mix"] - 0.7) < 1e-5, out
    assert np.allclose(out["spline_ends"], [(0, 0, 0), (4, 0, 3)], atol=1e-5), out
    return out


def run_game(runner, handles, frames: int = STREAM_FRAMES, click_at: int = 100):
    """Start the Runner, set the agents' paths, tick `frames` frames with a
    press on the button at frame `click_at` (released the frame after), and
    log the closest agents every 5th frame, the pinger's x every frame and
    the GUI's clicks. Returns (gaps, xs, clicks)."""
    runner.start()
    world = runner.world
    gm = world.modules["gui"]
    runner.state = start_navigation(runner.state, world, handles)
    slot = world.slot(handles["pinger"])
    gaps, xs, clicks = [], [], 0
    for f in range(frames):
        if f in (click_at, click_at + 1):
            runner.state = gm.inject_pointer(runner.state, *BUTTON_PIXEL, f == click_at)
        runner.tick()
        if f % 5 == 0:
            gaps.append(min_gap(runner.state, world, handles))
        xs.append(float(runner.state.local.pos[0, slot]))
        clicks += int(runner.state.modules["gui"].counters["clicks"])
    return gaps, xs, clicks
