"""OS layer (≙ reference src/core/os.h + win/linux impls): window/event
surface, monitors, clipboard, file dialogs, process/memory queries, gamepad
devices.

Headless-first: the same EVENT MODEL and API shape as the reference, with a
`HeadlessWindowBackend` default that a real platform backend (X11/win32)
could replace. Game/editor code written against this surface runs unchanged
in sims, tests and (with a backend) on a desktop. Events drain into the
engine's InputSystem each frame, exactly like the reference's
processEvents → InputSystem path.
"""
from __future__ import annotations

import os as _os
import time
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Tuple


class EventType(IntEnum):
    QUIT = 0
    WIN_SIZE = 1
    WIN_MOVE = 2
    MOUSE_BUTTON = 3
    MOUSE_MOVE = 4
    KEY = 5
    TEXT_INPUT = 6
    MOUSE_WHEEL = 7
    FOCUS = 8
    GAMEPAD_CONNECTED = 9
    GAMEPAD_DISCONNECTED = 10


class MouseButton(IntEnum):
    LEFT = 0
    RIGHT = 1
    MIDDLE = 2


class CursorType(IntEnum):
    DEFAULT = 0
    SIZE_NS = 1
    SIZE_WE = 2
    SIZE_NWSE = 3
    LOAD = 4
    TEXT_INPUT = 5
    CROSSHAIR = 6


@dataclass
class Event:
    type: EventType
    down: bool = False
    button: int = 0
    keycode: int = 0
    is_repeat: bool = False
    x: int = 0
    y: int = 0
    w: int = 0
    h: int = 0
    text: str = ""
    amount: float = 0.0
    gained: bool = False
    gamepad: int = 0


@dataclass
class Monitor:
    work_rect: Tuple[int, int, int, int] = (0, 0, 1920, 1080)
    monitor_rect: Tuple[int, int, int, int] = (0, 0, 1920, 1080)
    primary: bool = True


@dataclass
class WindowState:
    rect: Tuple[int, int, int, int] = (0, 0, 1280, 720)
    maximized: bool = False
    fullscreen: bool = False
    title: str = ""
    focused: bool = True
    cursor: CursorType = CursorType.DEFAULT


@dataclass
class GamepadState:
    """≙ the XInput/evdev controller state the reference polls per frame."""

    connected: bool = False
    axes: Dict[int, Tuple[float, float]] = field(default_factory=dict)
    buttons: Dict[int, bool] = field(default_factory=dict)
    rumble: Tuple[float, float] = (0.0, 0.0)   # low/high frequency motors


class HeadlessWindowBackend:
    """Injectable backend: tests/sims push events; a platform backend would
    pump the real OS queue instead."""

    def __init__(self):
        self.queue: List[Event] = []
        self.state = WindowState()
        self.monitors = [Monitor()]
        self.clipboard = ""
        self.gamepads: Dict[int, GamepadState] = {}

    def push(self, ev: Event) -> None:
        self.queue.append(ev)

    def poll(self) -> List[Event]:
        evs, self.queue = self.queue, []
        return evs


class OSLayer:
    """≙ os:: namespace — one instance per app (app.Runner owns it)."""

    def __init__(self, backend: Optional[HeadlessWindowBackend] = None):
        self.backend = backend or HeadlessWindowBackend()
        self.quit_requested = False
        self._rel_mouse = False

    # -- window ------------------------------------------------------------

    def create_window(self, title: str = "", size: Tuple[int, int] = (1280, 720)):
        self.backend.state.title = title
        self.backend.state.rect = (0, 0, size[0], size[1])
        return self.backend.state

    def window_state(self) -> WindowState:
        return self.backend.state

    def set_cursor(self, cursor: CursorType) -> None:
        self.backend.state.cursor = cursor

    def monitors(self) -> List[Monitor]:
        return self.backend.monitors

    # -- events (≙ processEvents → InputSystem) ----------------------------

    def process_events(self, input_system=None) -> List[Event]:
        """Drain backend events; forward input events into an InputSystem
        when given (keyboard/mouse/text/gamepad buttons)."""
        from lumixengine_tpu_torch.engine import input as inp

        evs = self.backend.poll()
        for ev in evs:
            # backend-state maintenance runs regardless of an attached
            # InputSystem (connection registry is OS state, not input routing)
            if ev.type == EventType.QUIT:
                self.quit_requested = True
            elif ev.type == EventType.GAMEPAD_CONNECTED:
                self.backend.gamepads[ev.gamepad] = GamepadState(connected=True)
            elif ev.type == EventType.GAMEPAD_DISCONNECTED:
                self.backend.gamepads.pop(ev.gamepad, None)
            if input_system is None:
                continue
            if ev.type == EventType.KEY:
                input_system.inject_button(inp.DEVICE_KEYBOARD, ev.keycode, ev.down)
            elif ev.type == EventType.MOUSE_BUTTON:
                input_system.inject_button(inp.DEVICE_MOUSE, ev.button, ev.down)
            elif ev.type == EventType.MOUSE_MOVE:
                input_system.inject_axis(inp.DEVICE_MOUSE, float(ev.x), float(ev.y))
            elif ev.type == EventType.MOUSE_WHEEL:
                # wheel rides the mouse device's axis 1 (x = amount)
                input_system.inject_axis(inp.DEVICE_MOUSE, float(ev.amount),
                                         0.0, axis_id=1)
            elif ev.type == EventType.TEXT_INPUT:
                input_system.inject_text(ev.text)
        return evs

    # -- gamepads (≙ XInput poll per frame) --------------------------------

    def gamepad(self, index: int = 0) -> Optional[GamepadState]:
        return self.backend.gamepads.get(index)

    def set_gamepad_axis(self, index: int, axis: int, x: float, y: float,
                         input_system=None) -> None:
        from lumixengine_tpu_torch.engine import input as inp

        pad = self.backend.gamepads.setdefault(index, GamepadState(connected=True))
        pad.axes[axis] = (x, y)
        if input_system is not None:
            input_system.inject_axis(inp.DEVICE_CONTROLLER, x, y,
                                     device_index=index, axis_id=axis)

    def set_gamepad_button(self, index: int, button: int, down: bool,
                           input_system=None) -> None:
        from lumixengine_tpu_torch.engine import input as inp

        pad = self.backend.gamepads.setdefault(index, GamepadState(connected=True))
        pad.buttons[button] = down
        if input_system is not None:
            input_system.inject_button(inp.DEVICE_CONTROLLER, button, down,
                                       device_index=index)

    def rumble(self, index: int, low: float, high: float) -> None:
        pad = self.backend.gamepads.get(index)
        if pad is not None:
            pad.rumble = (float(low), float(high))

    # -- clipboard / shell / process ---------------------------------------

    def copy_to_clipboard(self, text: str) -> None:
        self.backend.clipboard = text

    def get_clipboard(self) -> str:
        return self.backend.clipboard

    @staticmethod
    def get_cpus_count() -> int:
        return _os.cpu_count() or 1

    @staticmethod
    def sleep(ms: int) -> None:
        time.sleep(ms / 1000.0)

    @staticmethod
    def get_process_memory() -> int:
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * (_os.sysconf("SC_PAGE_SIZE"))
        except OSError:
            return 0

    @staticmethod
    def get_executable_path() -> str:
        import sys

        return sys.executable
