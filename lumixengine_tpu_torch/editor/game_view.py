"""Game view — play-in-editor (counterpart of
``lumixengine_tpu/editor/game_view.py``; ≙ reference renderer/editor/game_view.cpp:1-354
+ editor/world_editor.cpp:2252-2302 WorldEditor::toggleGameMode).

The reference's GameView renders the GAME camera through its own Pipeline
while WorldEditor owns game mode: entering play serializes the world into a
memory blob (world_editor.cpp:2263 `save(m_game_mode_file, true)`), leaving
play destroys the played world and restores the blob (:2299). Same split
here: `toggle_play` snapshots the world through engine/serialize.py, ticks a
Runner over the live world, presents from the game camera (NOT the editor
camera — that is the scene view's job), and on stop rebuilds a fresh World
from the blob and hands it back to the EditorApp via `on_world_replaced`.

Controls map the reference's GUI onto keys:
- time multiplier: '+'/'-' (game_view.cpp:203-205 DragFloat 0.01-30 wired to
  Engine::setTimeMultiplier → our `engine.time_multiplier`)
- pause / single-step: space / 'n' (≙ Engine::pause / Engine::nextFrame,
  which the engine already implements; studio's toolbar buttons)
- forced viewport: 'v' cycles off → 320x180 → 160x90 (≙ forceViewport,
  game_view.cpp:181-186)
- debug show: 'b' cycles none → depth (≙ controlsGUI's Debug popup — the
  software backend keeps a depth buffer; the ImGui build offers more
  channels because its deferred GBuffer has them)

The Runner steps on the engine's device (the card unless the engine was
made for the CPU); the stopped view's dt is a float32 zero on that device.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

_VIEWPORTS = [None, (320, 180), (160, 90)]
_DEBUG_MODES = ["none", "depth"]


class GameView:
    def __init__(self, engine, world,
                 on_world_replaced: Optional[Callable] = None):
        self.engine = engine
        self.world = world
        self.on_world_replaced = on_world_replaced
        self.playing = False
        self.status = "stopped — g starts game mode"
        self.frames = 0
        self.last_frame_ms = 0.0
        self.forced_viewport: Optional[tuple] = None
        self.debug_show = "none"
        self._blob: Optional[bytes] = None
        self._runner = None

    # -- game mode -----------------------------------------------------------

    def toggle_play(self) -> None:
        """≙ WorldEditor::toggleGameMode: play snapshots, stop restores."""
        if not self.playing:
            from lumixengine_tpu_torch.engine.serialize import serialize_world

            self._blob = serialize_world(self.world)
            self.engine.start_game(self.world)
            self.playing = True
            self.frames = 0
            self.status = "playing"
        else:
            from lumixengine_tpu_torch.engine.serialize import load_world

            self.engine.stop_game(self.world)
            self.engine.pause(False)
            restored = load_world(self.engine, self._blob)
            self._blob = None
            self._runner = None
            self.playing = False
            self.world = restored
            if self.on_world_replaced is not None:
                self.on_world_replaced(restored)
            self.status = "stopped — world restored to pre-play state"

    def runner(self):
        if self._runner is None:
            from lumixengine_tpu_torch import app as app_mod

            r = app_mod.Runner([], engine=self.engine)
            r.use_world(self.world)
            r.start()
            self._runner = r
        return self._runner

    def game_camera(self) -> int:
        rmod = self.world.modules.get("renderer")
        cam = int(getattr(rmod, "active_camera", 0) or 0)
        # its camera-store slot: an entity id below the store's capacity
        # would be read as a slot
        slot = rmod.cameras.slot_of(cam) if rmod is not None else -1
        return slot if slot >= 0 else cam

    # -- frame -----------------------------------------------------------------

    def tick_frame(self) -> None:
        """One editor frame while the view is focused: tick the game when
        playing (paused ticks still run — the engine zeroes dt, so host
        systems/GUI stay live exactly like Engine::update when paused)."""
        if not self.playing:
            return
        t0 = time.perf_counter()
        self.runner().tick()
        self.last_frame_ms = (time.perf_counter() - t0) * 1e3
        self.frames += 1

    def frame(self, width: int, height: int) -> np.ndarray:
        if self.forced_viewport is not None:
            width, height = self.forced_viewport
        r = self.runner()
        if not self.playing:
            # stopped: show the edited world (host truth), culled at dt=0
            r.state = self.world.device_state(r.device)
            r.state = r.step(r.state, torch.zeros((), dtype=torch.float32, device=r.device))
        img = r.present(cam_slot=self.game_camera(), width=width,
                        height=height)
        if self.debug_show == "depth":
            backend = getattr(r, "_present_backend", None)
            d = getattr(backend, "depth", None)
            if d is not None:
                d = d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)
                far = np.percentile(d[np.isfinite(d)], 98.0) if np.isfinite(
                    d).any() else 1.0
                g = np.clip(d / max(float(far), 1e-6), 0.0, 1.0)
                img = np.repeat((255 - g * 255).astype(np.uint8)[..., None],
                                3, axis=2)
        return img

    # -- UI ---------------------------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        ch = text.lower()
        if ch == "g":
            self.toggle_play()
        elif text == " " and self.playing:
            self.engine.pause(not self.engine.paused)
            self.status = "paused" if self.engine.paused else "playing"
        elif ch == "n" and self.playing and self.engine.paused:
            self.engine.next_frame()            # ≙ Engine::nextFrame
            self.tick_frame()
            self.status = f"stepped to frame {self.frames}"
        elif ch == "+":
            self.engine.time_multiplier = min(
                self.engine.time_multiplier * 1.25, 30.0)
            self.status = f"time x{self.engine.time_multiplier:.2f}"
        elif ch == "-":
            self.engine.time_multiplier = max(
                self.engine.time_multiplier / 1.25, 0.01)
            self.status = f"time x{self.engine.time_multiplier:.2f}"
        elif ch == "v":
            i = _VIEWPORTS.index(self.forced_viewport)
            self.forced_viewport = _VIEWPORTS[(i + 1) % len(_VIEWPORTS)]
            self.status = (f"forced viewport {self.forced_viewport}"
                           if self.forced_viewport else "viewport: window")
        elif ch == "b":
            i = _DEBUG_MODES.index(self.debug_show)
            self.debug_show = _DEBUG_MODES[(i + 1) % len(_DEBUG_MODES)]
            self.status = f"debug show: {self.debug_show}"

    def render_text(self, width: int = 100, height: int = 28) -> str:
        from lumixengine_tpu_torch.core.os_terminal import TerminalWindowBackend

        self.tick_frame()
        img_h = max((height - 2) * 2, 2)
        img = self.frame(max(width, 2), img_h)
        ansi = TerminalWindowBackend.ansi_image(img)
        state = ("PLAYING" if self.playing and not self.engine.paused
                 else "PAUSED" if self.playing else "STOPPED")
        head = (f"game view — {state} frame {self.frames} "
                f"{self.last_frame_ms:.1f} ms "
                f"time x{self.engine.time_multiplier:.2f}"
                + (f" viewport {self.forced_viewport}"
                   if self.forced_viewport else "")
                + (f" debug:{self.debug_show}"
                   if self.debug_show != "none" else ""))
        foot = (f"[{self.status}]  keys: g play/stop · space pause · n step · "
                "+/- time · v viewport · b debug")
        return "\n".join([head.ljust(width)[:width], ansi,
                          foot.ljust(width)[:width]])
