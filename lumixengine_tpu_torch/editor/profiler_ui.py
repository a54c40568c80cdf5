"""Profiler viewer (counterpart of
``lumixengine_tpu/editor/profiler_ui.py``; ≙ reference editor/profiler_ui.cpp:1-1766).

The reference's ProfilerUI renders the recorder's per-thread ring buffers as
a flamegraph (nested block bars over a time axis), a counters tab, and frame
markers, with pause + zoom. Same information here as a terminal flamegraph:
blocks from core/profiler.py's ring are nested by interval containment per
thread, laid out as depth rows of bars scaled to the viewed time window;
counters render as a latest/min/max table. Pure state machine + text
composer, like the other editor views.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from lumixengine_tpu_torch.core import profiler


class ProfilerUI:
    def __init__(self):
        self.blocks: List[Tuple[str, float, float, int]] = []
        self.frames: List[float] = []
        self.counters: Dict[str, List[Tuple[float, float]]] = {}
        self.mode = "flame"        # "flame" | "counters"
        self.frame_sel = -1        # -1 = last frame; else index into spans
        self.paused = False
        self.status = ""
        self.snapshot()

    # -- model ---------------------------------------------------------------

    def snapshot(self) -> None:
        """Copy the live rings (≙ ProfilerUI iterating ThreadContext rings;
        the recorder keeps running unless paused)."""
        self.blocks = profiler.blocks()
        self.frames = list(profiler._frames)
        self.counters = {name: profiler.counters(name)
                         for name in list(profiler._counters)}

    def frame_spans(self) -> List[Tuple[float, float]]:
        """Adjacent frame markers → [t0, t1) spans (≙ frame events)."""
        f = self.frames
        return [(f[i], f[i + 1]) for i in range(len(f) - 1)]

    def window(self) -> Tuple[float, float]:
        """The viewed time range: selected frame span, else last frame, else
        the whole ring."""
        spans = self.frame_spans()
        if spans:
            i = self.frame_sel if 0 <= self.frame_sel < len(spans) else -1
            return spans[i]
        if self.blocks:
            t0 = min(b[1] for b in self.blocks)
            t1 = max(b[2] for b in self.blocks)
            return t0, max(t1, t0 + 1e-9)
        return 0.0, 1.0

    def flame_rows(self, t0: float, t1: float
                   ) -> List[List[Tuple[str, float, float]]]:
        """Blocks overlapping [t0,t1) nested into depth rows (all threads
        merged; the engine is effectively single-host-threaded — the device's
        kernels own the parallelism). Row d holds (name, start, end) of depth-d blocks."""
        sel = sorted((b for b in self.blocks if b[2] > t0 and b[1] < t1),
                     key=lambda b: (b[1], -(b[2] - b[1])))
        rows: List[List[Tuple[str, float, float]]] = []
        stack: List[Tuple[float, int]] = []   # (end, depth)
        for name, s, e, _tid in sel:
            while stack and s >= stack[-1][0] - 1e-12:
                stack.pop()
            depth = len(stack)
            while len(rows) <= depth:
                rows.append([])
            rows[depth].append((name, s, e))
            stack.append((e, depth))
        return rows

    # -- UI --------------------------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        _LEFT, _RIGHT = 0x25, 0x27
        ch = text.lower()
        if ch == "c":
            self.mode = "counters" if self.mode == "flame" else "flame"
        elif ch == "p":
            self.paused = not self.paused
            profiler.pause(self.paused)
            self.status = "paused" if self.paused else "recording"
        elif ch == "r":
            self.snapshot()
            self.status = f"{len(self.blocks)} blocks"
        elif code == _LEFT:
            n = len(self.frame_spans())
            cur = self.frame_sel if self.frame_sel >= 0 else n - 1
            self.frame_sel = max(cur - 1, 0) if n else -1
        elif code == _RIGHT:
            n = len(self.frame_spans())
            if n:
                cur = self.frame_sel if self.frame_sel >= 0 else n - 1
                self.frame_sel = min(cur + 1, n - 1)

    def _render_flame(self, width: int, height: int) -> List[str]:
        t0, t1 = self.window()
        span = max(t1 - t0, 1e-9)
        rows = self.flame_rows(t0, t1)
        lines = []
        for row in rows[: height]:
            line = [" "] * width
            for name, s, e in row:
                c0 = max(int((s - t0) / span * width), 0)
                c1 = min(int((e - t0) / span * width + 0.9999), width)
                if c1 <= c0:
                    c1 = min(c0 + 1, width)
                label = f"[{name}"
                for i in range(c0, c1):
                    k = i - c0
                    line[i] = label[k] if k < len(label) else (
                        "]" if i == c1 - 1 else "#")
            lines.append("".join(line))
        if not lines:
            lines = ["(no blocks recorded — run with profiling enabled)"]
        return lines

    def _render_counters(self, width: int, height: int) -> List[str]:
        lines = []
        for name in sorted(self.counters):
            series = self.counters[name]
            if not series:
                continue
            vals = [v for _, v in series]
            lines.append(f"{name:<40} last={vals[-1]:<12.4g} "
                         f"min={min(vals):<12.4g} max={max(vals):<12.4g} "
                         f"n={len(vals)}"[:width])
        return lines or ["(no counters)"]

    def render_text(self, width: int = 100, height: int = 28) -> str:
        t0, t1 = self.window()
        spans = self.frame_spans()
        fi = (self.frame_sel if 0 <= self.frame_sel < len(spans)
              else len(spans) - 1)
        head = (f"profiler — {self.mode}  frame {fi + 1}/{len(spans)}  "
                f"window {1e3 * (t1 - t0):.2f} ms  "
                f"blocks {len(self.blocks)}"
                f"{'  [PAUSED]' if self.paused else ''}")
        body = height - 3
        if self.mode == "flame":
            mid = self._render_flame(width, body)
        else:
            mid = self._render_counters(width, body)
        mid = [ln.ljust(width)[:width] for ln in mid[:body]]
        mid += [" " * width] * (body - len(mid))
        foot = (f"[{self.status}]  keys: r refresh · c counters/flame · "
                "p pause · left/right frame")[:width].ljust(width)
        return "\n".join([head.ljust(width)[:width]] + mid
                         + ["-" * width, foot][:max(height - body - 1, 0)])
