"""App runner (counterpart of ``lumixengine_tpu/app.py``; ≙ reference
src/app/main.cpp Runner).

Boot: crash handler, settings and command line, an Engine with every
built-in system. Load: a world the caller builds (``use_world``). Loop: the
host frame (OS events, dt smoothing, scripts on the host interpreter, the
scripts' pending writes flushed into the device state) then the device step
(``Engine.build_step`` with the cull pass), then the GUI's button signals.
The step runs on the card unless the caller passes a CPU device.

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
item: loading a serialized or .unv world (host tier, Queue 1 item 7), the
present paths (render and present, Queue 1 item 6) and the per-phase cost
model (Queue 1 item 7).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from lumixengine_tpu_torch.core import config as cfg
from lumixengine_tpu_torch.core import debug as dbg
from lumixengine_tpu_torch.core import log, profiler
from lumixengine_tpu_torch.engine import reflection
from lumixengine_tpu_torch.engine.engine import Engine

_NOT_PORTED = "{what} is not ported yet (ROADMAP Queue 1 item {item})"


def create_full_engine(base_path: str = ".", device="cuda", **caps) -> Engine:
    """Engine with every built-in system registered, in the reference's
    order (≙ plugin.cpp createAllStatic: each LUMIX_PLUGIN_ENTRY). `device`
    is where a Runner on this engine builds its state and step."""
    from lumixengine_tpu_torch.animation.module import AnimationSystem
    from lumixengine_tpu_torch.audio.module import AudioSystem
    from lumixengine_tpu_torch.engine.core_module import CoreSystem
    from lumixengine_tpu_torch.gui.module import GuiSystem
    from lumixengine_tpu_torch.navigation.module import NavigationSystem
    from lumixengine_tpu_torch.physics.module import PhysicsSystem
    from lumixengine_tpu_torch.renderer.render_module import RendererSystem
    from lumixengine_tpu_torch.script.module import ScriptSystem

    engine = Engine(base_path=base_path)
    engine.module_capacities = caps
    engine.device = torch.device(device)
    renderer = RendererSystem(engine)
    engine.add_system(CoreSystem(engine))
    engine.add_system(renderer)
    engine.add_system(AnimationSystem(engine, renderer=renderer))
    engine.add_system(PhysicsSystem(engine))
    engine.add_system(ScriptSystem(engine))
    engine.add_system(NavigationSystem(engine))
    engine.add_system(GuiSystem(engine))
    engine.add_system(AudioSystem(engine))
    reflection.register_builtin_components()
    return engine


class Runner:
    """≙ app/main.cpp Runner struct."""

    def __init__(self, argv: Optional[List[str]] = None, base_path: str = ".",
                 engine: Optional[Engine] = None):
        dbg.install_crash_handler(base_path)
        self.settings = cfg.Settings()
        self.settings.register("world", "", "app")
        self.settings.register("profile_start", False, "app")
        self.settings.register("fps_cap", 60.0, "app")
        self.cli = cfg.CommandLineParser(argv or [])
        self.cli.apply_to_settings(self.settings)

        self.engine = engine or create_full_engine(base_path)
        # the engine's device: create_full_engine(device=...) picks it
        self.device = getattr(self.engine, "device", torch.device("cuda"))
        # OS layer (≙ os:: init + main window): headless backend, pumped into
        # the InputSystem each tick
        from lumixengine_tpu_torch.core.os import OSLayer
        self.os = OSLayer()
        self.os.create_window(title="lumixengine_tpu_torch")
        self.world = None
        self.state = None
        self.step = None
        self.frame_index = 0
        self._fixed_dt = None
        self._miss_warned = False

    # -- boot (≙ Runner::onInit) --------------------------------------------------

    def load_project(self, path: str) -> None:
        proj = cfg.Project.loads(self.engine.fs.read(path).decode())
        if proj.startup_world and not self.settings.get("world"):
            self.settings.set("world", proj.startup_world)
        for k, v in proj.settings.items():
            if k in self.settings.options:
                self.settings.set(k, v)

    def load_world(self, path_or_blob) -> None:
        raise NotImplementedError(_NOT_PORTED.format(
            what="loading a serialized or .unv world (engine/serialize.py, importers/)", item=7))

    def use_world(self, world) -> None:
        self.world = world

    def start(self, fixed_dt: Optional[float] = 1.0 / 60.0) -> None:
        """Start the game, THEN build the step (≙ startGame): scripts'
        start() writes land in the host world and are captured by the
        snapshot, and the device fast path (script/lua_fastpath.py) compiles
        update() bodies against their post-start() chunk locals."""
        assert self.world is not None, "load or set a world first"
        self._fixed_dt = fixed_dt
        self.engine.start_game(self.world)
        with profiler.block("build_step"):
            self._build_and_snapshot()
        if self.settings.get("profile_start"):
            profiler.enable(True)

    def _build_and_snapshot(self) -> None:
        rmod = self.world.modules.get("renderer")
        extra = rmod.cull_pass if rmod is not None else None
        self.step = self.engine.build_step(self.world, self.device, extra=extra)
        self.state = self.world.device_state(self.device)
        self._state_perm = self.world._slot_of.copy()

    def _rebuild_after_structure_change(self, skip_entities) -> None:
        """Script structural edits (spawn/destroy) rebuild the step: the
        device state goes back to the host first (through the old
        snapshot's permutation), so the new snapshot resumes from the
        current simulation."""
        self.world.load_state(self.state, slot_of=self._state_perm, skip=skip_entities)
        with profiler.block("rebuild_step"):
            self._build_and_snapshot()

    # -- frame (≙ Runner::onIdle) ----------------------------------------------------

    def tick(self, dt_raw: Optional[float] = None) -> None:
        dt_raw = self._fixed_dt if dt_raw is None else dt_raw
        with profiler.block("frame"):
            self.os.process_events(self.engine.input)
            rsys = getattr(self.world.modules.get("renderer"), "system", None)
            if rsys is not None:
                for p in getattr(rsys, "plugins", ()):  # ≙ RenderPlugin::frame
                    p.frame(rsys)
            dt = self.engine.update_host(dt_raw)
            sm = self.world.modules.get("script")
            if sm is not None:
                with profiler.block("scripts"):
                    sm.latest_state = self.state   # last frame's sim results
                    sm.poll_events(self.state)     # onPathFinished etc.
                    sm.update_host(dt)
                    for ev in self.engine.input.events:
                        sm.on_input(ev)
                if sm.has_lua():
                    rt = sm._lua_rt
                    if sm.consume_structure_dirty():
                        self._rebuild_after_structure_change(rt.dirty_transforms)
                        rt.dirty_transforms.clear()
                    self.state = sm.apply_pending(self.state, dt)
            with profiler.block("device_step"):
                self.state = self.step(self.state, dt)
            # gui button → script signal connections fire during play; no
            # readback unless a press edge is pending
            gm = self.world.modules.get("gui")
            if gm is not None:
                gm.pump_signals(self.state)
        profiler.frame()
        self.frame_index += 1
        # broadphase-integrity watchdog (a scalar readback every 64 frames):
        # a nonzero window/budget miss means the broadphase dropped real
        # contact pairs, i.e. the simulation is silently incomplete
        if self.frame_index % 64 == 0 and not self._miss_warned:
            pm = self.state.modules.get("physics")
            ctr = getattr(pm, "counters", None) or {}
            for key in ("sap_window_miss", "pruned_pair_miss"):
                if key in ctr and int(ctr[key].sum()) > 0:
                    log.log_warning(
                        "physics",
                        f"broadphase dropped pairs ({key}={int(ctr[key].sum())} "
                        f"at frame {self.frame_index}): simulation is "
                        "incomplete — raise sap_sweeps/sap_neighbors "
                        "(banded) or pair budget (pruned)")
                    self._miss_warned = True

    def run(self, frames: int) -> None:
        for _ in range(frames):
            self.tick()

    # -- render extraction ------------------------------------------------------------

    def prepare_view(self, cam_slot: int = 0):
        from lumixengine_tpu_torch.renderer import pipeline as pipe

        return pipe.prepare_view(self.state, self.world.modules["renderer"], cam_slot)

    def present(self, path: Optional[str] = None, cam_slot: int = 0,
                width: int = 480, height: int = 270):
        raise NotImplementedError(_NOT_PORTED.format(
            what="the software present (renderer/gpu_soft.py)", item=6))

    def present_tpu(self, path: Optional[str] = None, cam_slot: int = 0,
                    width: int = 480, height: int = 270, gui: bool = True):
        raise NotImplementedError(_NOT_PORTED.format(
            what="the on-device present (renderer/gpu_tpu.py)", item=6))

    def metrics(self, phases: bool = False) -> dict:
        """Frame, time and every module counter (summed over a world batch)."""
        out = {"frame": int(self.state.frame.reshape(-1)[0]),
               "time": float(self.state.time.reshape(-1)[0])}
        for mname, ms in self.state.modules.items():
            counters = getattr(ms, "counters", None)
            if isinstance(counters, dict):
                for k, v in counters.items():
                    out[f"{mname}.{k}"] = float(v.sum()) if isinstance(v, torch.Tensor) else v
        if phases:
            out.update(self.phase_metrics())
        return out

    def phase_metrics(self) -> dict:
        raise NotImplementedError(_NOT_PORTED.format(
            what="the per-phase cost model (engine/phase_profile.py)", item=7))

    def shutdown(self, trace_path: Optional[str] = None) -> None:
        self.engine.stop_game(self.world)
        if trace_path:
            profiler.export_chrome_trace(trace_path)
