"""App runner (counterpart of ``lumixengine_tpu/app.py``; ≙ reference
src/app/main.cpp Runner).

Boot: crash handler, settings and command line, an Engine with every
built-in system. Load: a world the caller builds (``use_world``), a world
blob (``engine/serialize.py``) or a reference ``.unv`` world, which brings
its own engine sized for the scene (``load_world``). Loop: the
host frame (OS events, dt smoothing, scripts on the host interpreter, the
scripts' pending writes flushed into the device state) then the device step
(``Engine.build_step`` with the cull pass), then the GUI's button signals.
The step runs on the card unless the caller passes a CPU device. Present:
``present`` replays the frame's DrawStream through the software backend
(host raster, postprocess passes on the card, TAA history kept across
calls); ``present_tpu`` rasterizes on the card and returns the image, the
depth and the overflow count. ``metrics(phases=True)`` adds the per-phase
cost model (``engine/phase_profile.py``). ``main`` boots the headless demo
world, or the world given with ``--world`` (a blob or a .unv), runs the
frames, in the terminal with ``--tui`` (``core/os_terminal.py``: keys in,
each frame presented as ANSI half-blocks), and writes a screenshot:

    python -m lumixengine_tpu_torch.app --frames 60 --screenshot out.png [--device cpu]
    python -m lumixengine_tpu_torch.app --world maps/x.unv --frames 60 [--device cpu]
    python -m lumixengine_tpu_torch.app --tui --frames 600 [--device cpu]
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from lumixengine_tpu_torch.core import config as cfg
from lumixengine_tpu_torch.core import debug as dbg
from lumixengine_tpu_torch.core import log, profiler
from lumixengine_tpu_torch.engine import reflection, serialize
from lumixengine_tpu_torch.engine.engine import Engine



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
        self.settings.register("screenshot", "", "app")
        self.settings.register("tui", False, "app")
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
        self._present_backend = None
        self._present_tpu = None
        self._extra = None
        self._phase_profile = None
        self._frame_ms_ema = None
        self._last_tick_t = None

    # -- boot (≙ Runner::onInit) --------------------------------------------------

    def load_project(self, path: str) -> None:
        proj = cfg.Project.loads(self.engine.fs.read(path).decode())
        if proj.startup_world and not self.settings.get("world"):
            self.settings.set("world", proj.startup_world)
        for k, v in proj.settings.items():
            if k in self.settings.options:
                self.settings.set(k, v)

    def load_world(self, path_or_blob) -> None:
        """Load this engine's world blob (bytes, or a path the engine's file
        system reads) or a reference ``.unv`` world, told by its extension
        or its 'LWRL' magic. A .unv goes through the importer, which builds
        an engine sized for the scene's banks on this Runner's device, its
        assets resolved against the engine's base path; the Runner adopts
        that engine (state attached to the old one does not carry over)."""
        if isinstance(path_or_blob, str) and _is_unv(path_or_blob):
            from lumixengine_tpu_torch.importers.instantiate import load_world as load_unv_world

            base = self.engine.fs.base_path
            scene = load_unv_world(path_or_blob, data_dirs=(base,), device=self.device,
                                   base_path=base)
            self.engine = scene.engine
            self.world = scene.world
            return
        blob = (self.engine.fs.read(path_or_blob) if isinstance(path_or_blob, str)
                else path_or_blob)
        self.world = serialize.load_world(self.engine, blob)

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
        self._extra = extra
        self._phase_profile = None     # the per-phase cost shares, built lazily
        self._frame_ms_ema = None      # tick-to-tick wall time, EMA

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
        now = time.perf_counter()
        if self._last_tick_t is not None:
            ms = (now - self._last_tick_t) * 1e3
            ema = self._frame_ms_ema
            self._frame_ms_ema = ms if ema is None else 0.9 * ema + 0.1 * ms
        self._last_tick_t = now
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
        """Record this frame's DrawStream and replay it through the software
        backend (host raster, the registered RenderPlugins' passes on the
        state's device). The backend is kept across calls, so TAA history
        accumulates. Returns the uint8 image [H, W, 3]; writes a PNG at
        `path` when given."""
        from lumixengine_tpu_torch.renderer import gpu_soft

        img, self._present_backend = gpu_soft.render_frame(
            self, path, cam_slot, width, height, backend=self._present_backend)
        return img

    def present_tpu(self, path: Optional[str] = None, cam_slot: int = 0,
                    width: int = 480, height: int = 270, gui: bool = True):
        """The on-device present (renderer/gpu_tpu.py): the scene is
        tile-binned and z-filled on the state's device, rebaked on a topology
        change; only the image crosses to the host, where the GUI (host
        content) composites over it. Returns (rgb uint8 [H, W, 3], depth f32
        [H, W], overflow int); writes a PNG at `path` when given."""
        from lumixengine_tpu_torch.renderer import gpu_tpu

        tp = self._present_tpu
        if tp is None or (tp.width, tp.height) != (width, height):
            tp = self._present_tpu = gpu_tpu.TpuPresent(width, height)
        rgb, depth, overflow = tp(self, cam_slot)
        rgb = rgb.cpu().numpy()
        if gui and self.world.modules.get("gui") is not None:
            from lumixengine_tpu_torch.renderer.gpu_soft import compose_gui

            buf = compose_gui(rgb.astype(np.float32), self, width, height)
            rgb = np.clip(buf, 0, 255).astype(np.uint8)
        if path is not None:
            from lumixengine_tpu_torch.renderer.texture import write_png

            write_png(path, rgb)
        return rgb, depth.cpu().numpy(), int(overflow)

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
        """The tick-to-tick frame time split across the module phases by
        each phase's modelled roofline cost (engine/phase_profile.py):
        ``phase.<k>.frac``, ``phase.<k>.est_ms`` (a model, not a
        measurement) and ``frame_ms``. The profile is taken once per step
        build, on the current state."""
        from lumixengine_tpu_torch.engine import phase_profile as pp

        if self._phase_profile is None:
            self._phase_profile = pp.profile_phases(
                self.world, self.state, dt=self._fixed_dt or 1.0 / 60.0, extra=self._extra)
        out = {}
        frame_ms = self._frame_ms_ema
        for k, c in self._phase_profile.items():
            out[f"phase.{k}.frac"] = round(c["frac"], 4)
            if frame_ms is not None:
                v = c["frac"] * frame_ms
                out[f"phase.{k}.est_ms"] = round(v, 4)
                profiler.push_counter(f"phase.{k}.est_ms", v)
        if frame_ms is not None:
            out["frame_ms"] = round(frame_ms, 4)
        return out

    def shutdown(self, trace_path: Optional[str] = None) -> None:
        self.engine.stop_game(self.world)
        if trace_path:
            profiler.export_chrome_trace(trace_path)


def _is_unv(path: str) -> bool:
    """A reference world file: the .unv extension, or the 'LWRL' magic
    (b"LRWL" on disk, little-endian)."""
    if path.endswith(".unv"):
        return True
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"LRWL"
    except OSError:
        return False


def _run_tui(runner: "Runner", frames: int) -> None:
    """Interactive terminal session: the TerminalWindowBackend pumps raw
    keyboard input into the InputSystem and each frame presents through the
    software present at 320x180 as ANSI half-blocks (≙ the platform main
    loop: processEvents → update → Pipeline::render → swap), at most
    `fps_cap` frames a second. Ctrl-C quits."""
    from lumixengine_tpu_torch.core.os_terminal import TerminalWindowBackend
    from lumixengine_tpu_torch.renderer.plugins import install_builtins

    install_builtins(runner.world.modules["renderer"].system)
    backend = TerminalWindowBackend()
    runner.os.backend = backend
    cap = float(runner.settings.get("fps_cap") or 30.0)
    with backend:
        for _ in range(frames):
            t0 = time.perf_counter()
            runner.tick()
            img = runner.present(width=320, height=180)
            backend.present(img)
            if runner.os.quit_requested:
                break
            left = 1.0 / cap - (time.perf_counter() - t0)
            if left > 0:
                time.sleep(left)


def main(argv: Optional[List[str]] = None) -> int:
    """Boot the `--world` (a world blob or a .unv), else the headless demo
    world (2,048 entities), on `--device` (the card unless `cpu` is given),
    run `--frames` frames (300), then present a `--screenshot` PNG through
    the software present with the builtin plugins, and print the metrics."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    cli = cfg.CommandLineParser(argv)
    device = torch.device(cli.value("device", "cuda"))
    if cli.value("world"):
        runner = Runner(argv, engine=create_full_engine(device=device))
        runner.load_world(runner.settings.get("world"))
    else:
        # no world given: boot the headless demo scene
        from lumixengine_tpu_torch.models import demo_scenes

        engine, world, _ = demo_scenes.headless_demo_world(num_entities=2048)
        engine.device = device
        runner = Runner(argv, engine=engine)
        runner.use_world(world)
    runner.start()
    frames = int(cli.value("frames", "300"))
    t0 = time.perf_counter()
    if runner.settings.get("tui"):
        _run_tui(runner, frames)
    else:
        runner.run(frames)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    el = time.perf_counter() - t0
    log.log_info("app", f"{frames} frames in {el:.2f}s ({frames / el:.1f} fps)")
    shot = runner.settings.get("screenshot")
    if shot:
        from lumixengine_tpu_torch.renderer.plugins import install_builtins

        install_builtins(runner.world.modules["renderer"].system)
        runner.present(str(shot))
        log.log_info("app", f"screenshot -> {shot}")
    print(runner.metrics())
    runner.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
