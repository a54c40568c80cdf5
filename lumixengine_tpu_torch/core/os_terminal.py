"""Terminal platform backend for the OS layer (counterpart of
``lumixengine_tpu/core/os_terminal.py``; ≙ the role of the reference's
src/core/win/os.cpp / linux os.cpp: pump real platform input into the engine
and present frames to a real surface — on this headless TPU box the terminal
IS the platform, so keys come from raw-mode stdin escape parsing and frames
present as ANSI truecolor half-blocks).

Drop-in for HeadlessWindowBackend: same poll()/state/monitors/clipboard/
gamepads surface. Key semantics: terminals deliver key *presses* only, so
each press synthesizes a KEY down and the matching KEY up is emitted on the
following poll (held keys auto-repeat into fresh down events, which the
InputSystem already treats as held state refreshes). Printable characters
additionally emit TEXT_INPUT, like the reference's WM_CHAR path.
"""
from __future__ import annotations

import os as _os
import select
import sys
from typing import List, Optional

import numpy as np

from lumixengine_tpu_torch.core.os import (Event, EventType,
                                     HeadlessWindowBackend)

# VK-style codes (the convention engine/input.py documents)
_VK = {"\x1b[A": 0x26, "\x1b[B": 0x28, "\x1b[C": 0x27, "\x1b[D": 0x25,
       "\x7f": 8, "\r": 13, "\n": 13, "\t": 9, " ": 0x20}


class TerminalWindowBackend(HeadlessWindowBackend):
    """Raw-mode stdin input + ANSI half-block present."""

    def __init__(self, out=None, max_cols: int = 160):
        super().__init__()
        self.out = out or sys.stdout
        self.max_cols = max_cols
        self._pending_up: List[int] = []
        self._raw_fd: Optional[int] = None
        self._saved_attrs = None
        self._entered = False

    # -- terminal lifecycle --------------------------------------------------

    def enter(self) -> None:
        """Raw mode + alt screen + hidden cursor. Safe to call headless
        (no tty: input is skipped, present still writes)."""
        self._entered = True
        try:
            import termios
            import tty

            if sys.stdin.isatty():
                self._raw_fd = sys.stdin.fileno()
                self._saved_attrs = termios.tcgetattr(self._raw_fd)
                tty.setcbreak(self._raw_fd)
        except Exception:
            self._raw_fd = None
        self.out.write("\x1b[?1049h\x1b[?25l\x1b[2J")
        self.out.flush()

    def exit(self) -> None:
        if not self._entered:
            return
        if self._saved_attrs is not None:
            import termios

            termios.tcsetattr(self._raw_fd, termios.TCSADRAIN,
                              self._saved_attrs)
        self.out.write("\x1b[?25h\x1b[?1049l")
        self.out.flush()
        self._entered = False

    def __enter__(self):
        self.enter()
        return self

    def __exit__(self, *exc):
        self.exit()

    # -- input ----------------------------------------------------------------

    def _read_pending(self) -> str:
        if self._raw_fd is None:
            return ""
        buf = ""
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = _os.read(self._raw_fd, 64).decode("utf-8", "ignore")
            if not ch:
                break
            buf += ch
        return buf

    def poll(self) -> List[Event]:
        evs = super().poll()              # injected events still flow
        for code in self._pending_up:
            evs.append(Event(EventType.KEY, down=False, keycode=code))
        self._pending_up = []
        buf = self._read_pending()
        i = 0
        while i < len(buf):
            ch = buf[i]
            seq3 = buf[i:i + 3]
            if seq3 in _VK:
                code = _VK[seq3]
                i += 3
            elif ch == "\x03":            # Ctrl-C
                evs.append(Event(EventType.QUIT))
                i += 1
                continue
            elif ch in _VK:
                code = _VK[ch]
                i += 1
            elif ch == "\x1b":            # unknown escape: swallow sequence
                i += len(buf[i:].split("~")[0]) + 1 if "~" in buf[i:] else 3
                continue
            else:
                code = ord(ch.upper()) if ch.isprintable() else 0
                i += 1
                if code == 0:
                    continue
            evs.append(Event(EventType.KEY, down=True, keycode=code))
            if "\x20" <= ch < "\x7f":
                evs.append(Event(EventType.TEXT_INPUT, text=ch))
            self._pending_up.append(code)
        return evs

    # -- present ----------------------------------------------------------------

    def term_size(self):
        try:
            sz = _os.get_terminal_size(self.out.fileno())
            return min(sz.columns, self.max_cols), sz.lines
        except (OSError, ValueError):
            return min(80, self.max_cols), 24

    @staticmethod
    def ansi_image(img: np.ndarray) -> str:
        """Pure uint8 [H, W, 3] → ANSI half-block string at the image's own
        resolution (one cell per 1x2 pixel column), no tty, no resize —
        composable into other views (editor scene view)."""
        top = img[0::2]
        bot = img[1::2][: top.shape[0]]
        out = []
        for r in range(top.shape[0]):
            last = None
            row = []
            for c in range(img.shape[1]):
                tr, tg, tb = top[r, c]
                br, bg_, bb = bot[r, c] if r < bot.shape[0] else (0, 0, 0)
                key = (tr, tg, tb, br, bg_, bb)
                if key != last:
                    row.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                               f"\x1b[48;2;{br};{bg_};{bb}m")
                    last = key
                row.append("▀")
            out.append("".join(row) + "\x1b[0m")
        return "\n".join(out)

    def present(self, img: np.ndarray) -> str:
        """uint8 [H, W, 3] → ANSI half-block frame (2 pixels per cell row:
        fg=upper ▀, bg=lower). Returns the emitted string (tests assert on
        it); writes + flushes to `out`."""
        cols, lines = self.term_size()
        rows = max((lines - 1) * 2, 2)
        h, w = img.shape[:2]
        # nearest resize to cols x rows via index sampling
        yi = (np.arange(rows) * (h / rows)).astype(np.int32).clip(0, h - 1)
        xi = (np.arange(cols) * (w / cols)).astype(np.int32).clip(0, w - 1)
        small = img[yi][:, xi]
        top = small[0::2]
        bot = small[1::2][:top.shape[0]]
        parts = ["\x1b[H"]
        for r in range(top.shape[0]):
            last = None
            row = []
            for c in range(cols):
                tr, tg, tb = top[r, c]
                br, bg_, bb = bot[r, c]
                key = (tr, tg, tb, br, bg_, bb)
                if key != last:
                    row.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                               f"\x1b[48;2;{br};{bg_};{bb}m")
                    last = key
                row.append("▀")
            parts.append("".join(row) + "\x1b[0m\n")
        frame = "".join(parts)
        self.out.write(frame)
        self.out.flush()
        return frame
