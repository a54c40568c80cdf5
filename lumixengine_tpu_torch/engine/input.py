"""InputSystem (≙ reference engine/input_system.{h,cpp}).

Reference: OS events → device/button/axis/text events consumed by game code
each frame; devices are mouse/keyboard/gamepads (XInput/evdev).

TPU build (headless-first): the same event model with injectable sources —
scripted/recorded input for headless sims and tests, real OS hooks pluggable.
Event types and the per-frame drain contract mirror input_system.h.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_KEYBOARD = 0
DEVICE_MOUSE = 1
DEVICE_CONTROLLER = 2

EVENT_BUTTON = 0
EVENT_AXIS = 1
EVENT_TEXT = 2

# editing keys (≙ reference OS keycodes consumed by GUI input fields)
KEY_BACKSPACE = 8
KEY_TAB = 9
KEY_RETURN = 13
KEY_END = 0x23
KEY_HOME = 0x24
KEY_LEFT = 0x25
KEY_RIGHT = 0x27
KEY_DELETE = 127


@dataclass
class InputEvent:
    type: int
    device: int
    device_index: int = 0
    key_id: int = 0
    down: bool = False
    x: float = 0.0
    y: float = 0.0
    text: str = ""


class InputSystem:
    def __init__(self):
        self._queue: List[InputEvent] = []
        self.events: List[InputEvent] = []       # this frame's events
        self.down_keys: Dict[Tuple[int, int], bool] = {}
        self.mouse_pos = (0.0, 0.0)
        self.axes: Dict[Tuple[int, int], Tuple[float, float]] = {}

    # -- injection (OS hook or script/test source) ------------------------------

    def inject_button(self, device: int, key_id: int, down: bool, device_index: int = 0) -> None:
        self._queue.append(InputEvent(EVENT_BUTTON, device, device_index, key_id, down))

    def inject_axis(self, device: int, x: float, y: float, device_index: int = 0, axis_id: int = 0) -> None:
        self._queue.append(InputEvent(EVENT_AXIS, device, device_index, axis_id, x=x, y=y))

    def inject_text(self, text: str) -> None:
        self._queue.append(InputEvent(EVENT_TEXT, DEVICE_KEYBOARD, text=text))

    # -- frame update (≙ InputSystem::update) -------------------------------------

    def update(self) -> None:
        self.events = self._queue
        self._queue = []
        for ev in self.events:
            if ev.type == EVENT_BUTTON:
                self.down_keys[(ev.device, ev.key_id)] = ev.down
            elif ev.type == EVENT_AXIS:
                self.axes[(ev.device, ev.key_id)] = (ev.x, ev.y)
                if ev.device == DEVICE_MOUSE:
                    self.mouse_pos = (ev.x, ev.y)

    def is_down(self, key_id: int, device: int = DEVICE_KEYBOARD) -> bool:
        return self.down_keys.get((device, key_id), False)

    def axis(self, axis_id: int = 0, device: int = DEVICE_CONTROLLER) -> Tuple[float, float]:
        return self.axes.get((device, axis_id), (0.0, 0.0))
