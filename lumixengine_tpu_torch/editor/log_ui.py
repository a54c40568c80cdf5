"""Log view (counterpart of
``lumixengine_tpu/editor/log_ui.py``; ≙ reference editor/log_ui.cpp:1-252 + log_ui.h — a GUIPlugin
that subscribes to the engine log, buffers messages with per-level unread
counts, filters by level/text, autoscrolls, and floats error
notifications that fade out).

Same surface here: `LogUI` registers a callback with core/log.py's fan-out,
keeps a bounded message ring, per-level show toggles ('i'/'w'/'e' ≙ the
info/warnings/errors checkboxes), a substring filter (type to filter — ≙
TextFilter), autoscroll toggle, unread counts that clear when the view
renders (≙ m_new_message_count reset in onGUI), and timed notifications
for warnings/errors (≙ showNotifications' 10-second toasts)."""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

from lumixengine_tpu_torch.core import log as core_log

_LEVEL_NAMES = {0: "info", 1: "warn", 2: "error"}
_NOTIFICATION_SECONDS = 10.0    # ≙ log_ui.cpp notification fade time
_MAX_MESSAGES = 2048


class LogUI:
    def __init__(self, clock=time.monotonic):
        self.messages: List[Tuple[int, str, str]] = []  # (level, sys, text)
        self.new_count = {0: 0, 1: 0, 2: 0}             # unread per level
        self.notifications: List[Tuple[float, int, str]] = []
        self.show = {0: True, 1: True, 2: True}
        self.filter = ""
        self.autoscroll = True
        self.scroll = 0
        self.status = "log"
        self.edit: Optional[str] = None     # typing state for the filter
        self._clock = clock
        core_log.register_callback(self._on_log)

    def close(self) -> None:
        core_log.unregister_callback(self._on_log)

    # -- sink -----------------------------------------------------------------

    def _on_log(self, level: int, system: str, message: str) -> None:
        self.messages.append((level, system, message))
        if len(self.messages) > _MAX_MESSAGES:
            del self.messages[: len(self.messages) - _MAX_MESSAGES]
        self.new_count[level] = self.new_count.get(level, 0) + 1
        if level >= 1:   # warnings + errors float as notifications
            self.notifications.append((self._clock(), level, message))

    # -- model ------------------------------------------------------------------

    def visible(self) -> List[Tuple[int, str, str]]:
        f = self.filter.lower()
        return [m for m in self.messages
                if self.show.get(m[0], True)
                and (not f or f in m[1].lower() or f in m[2].lower())]

    def live_notifications(self) -> List[Tuple[int, str]]:
        now = self._clock()
        self.notifications = [n for n in self.notifications
                              if now - n[0] < _NOTIFICATION_SECONDS]
        return [(lv, msg) for _, lv, msg in self.notifications]

    # -- keys --------------------------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        if self.edit is not None:
            if code == 13:
                self.filter, self.edit = self.edit, None
                self.status = f"filter: {self.filter!r}"
            elif code == 27:
                self.edit = None
            elif code == 8:
                self.edit = self.edit[:-1]
            elif text:
                self.edit += text
            return
        ch = text.lower()
        if ch == "i":
            self.show[0] = not self.show[0]
        elif ch == "w":
            self.show[1] = not self.show[1]
        elif ch == "e":
            self.show[2] = not self.show[2]
        elif ch == "a":
            self.autoscroll = not self.autoscroll
            self.status = f"autoscroll {'on' if self.autoscroll else 'off'}"
        elif ch == "f":
            self.edit = ""
            self.status = "typing filter — enter applies, esc cancels"
        elif ch == "c":
            self.messages.clear()
            self.status = "cleared"
        elif code == 0x26:                  # up: scroll back, stops autoscroll
            self.scroll += 1
            self.autoscroll = False
        elif code == 0x28:
            self.scroll = max(self.scroll - 1, 0)

    # -- render ------------------------------------------------------------------

    def render_text(self, width: int = 100, height: int = 28) -> str:
        vis = self.visible()
        body = height - 3
        if self.autoscroll:
            self.scroll = 0
        start = max(0, len(vis) - body - self.scroll)
        counts = " ".join(f"{_LEVEL_NAMES[l]}:{self.new_count.get(l, 0)}"
                          + ("" if self.show[l] else "(hidden)")
                          for l in (0, 1, 2))
        lines = [f"log — {len(vis)}/{len(self.messages)} shown  "
                 f"new {counts}"
                 + (f"  filter={self.filter!r}" if self.filter else "")
                 .ljust(width)[:width]]
        for m in vis[start: start + body]:
            lv, sys_, txt = m
            tag = {0: " ", 1: "W", 2: "E"}[lv]
            lines.append(f"{tag} [{sys_}] {txt}"[:width].ljust(width))
        while len(lines) < height - 2:
            lines.append("".ljust(width))
        toasts = self.live_notifications()
        if toasts:
            lv, msg = toasts[-1]
            lines.append((f"!! {_LEVEL_NAMES[lv]}: {msg}"
                          f" ({len(toasts)} notification(s))")
                         [:width].ljust(width))
        else:
            lines.append("".ljust(width))
        filt = (self.edit + "_") if self.edit is not None else ""
        lines.append((f"[{self.status}] {filt} keys: i/w/e levels · "
                      "f filter · a autoscroll · c clear · up/down scroll")
                     [:width].ljust(width))
        # unread counters clear once seen (≙ onGUI resetting
        # m_new_message_count after the window draws)
        self.new_count = {0: 0, 1: 0, 2: 0}
        return "\n".join(lines[:height])
