"""Particle script editor view (counterpart of
``lumixengine_tpu/editor/particle_editor.py``; ≙ reference renderer/editor
particle_editor.cpp — there an ImGui node/curve editor over the .pat
compiler; here a source-pane TUI over the SAME compiler, so every edit goes
through the real `.pat` → torch pipeline with its real error messages).

Three panes:
  * source — the .pat text, line-selectable; enter edits the selected line,
    'a' appends a line after it, 'x' deletes it;
  * compile — per-emitter summary from the last compile (caps, channel
    layout, functions) or the CompileError with its message;
  * preview — the compiled system stepped from scratch: per-emitter alive
    counts as a sparkline over the last frames.

The preview runs on the editor's `device` (the card unless the caller
passes a CPU device), keyed by the threefry stream of ``core/random.py``
from ``PRNGKey(0)``, split once a frame as ``jax.random.split`` does.
Imports (``import "x.pai"``) resolve against the script's directory and its
parent.

Keys: up/down select line · enter edit (enter commits, esc cancels) ·
a append line · x delete line · c compile · p step preview 30 frames ·
s save · esc back.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

_UP, _DOWN, _ENTER = 0x26, 0x28, 13
_SPARK = " .:-=+*#%@"


class ParticleEditor:
    def __init__(self, path: str, source: Optional[str] = None, device="cuda"):
        self.path = path
        self.device = torch.device(device)
        if source is None:
            with open(path, "r", errors="replace") as f:
                source = f.read()
        self.lines: List[str] = source.splitlines()
        self.sel = 0
        self.edit: Optional[str] = None
        self.status = "particle editor"
        self.emitters = None          # name → CompiledEmitter
        self.error: Optional[str] = None
        self.history: Dict[str, List[int]] = {}
        self.compile()

    # -- compiler bridge ---------------------------------------------------

    def _resolve(self, path: str) -> str:
        base = os.path.dirname(os.path.abspath(self.path))
        roots = (base, os.path.join(base, ".."))
        names = (path, path.lstrip("/"), path.lstrip("/").removeprefix("engine/"),
                 os.path.basename(path))
        for r in roots:
            for n in names:
                cand = os.path.join(r, n)
                if os.path.isfile(cand):
                    with open(cand, "r", errors="replace") as f:
                        return f.read()
        raise FileNotFoundError(path)

    def source(self) -> str:
        return "\n".join(self.lines) + "\n"

    def compile(self) -> bool:
        from lumixengine_tpu_torch.renderer.particle_compiler import (
            CompileError, compile_source)

        try:
            self.emitters = compile_source(self.source(),
                                           resolve=self._resolve)
            self.error = None
            self.status = f"compiled: {len(self.emitters)} emitter(s)"
            return True
        except (CompileError, FileNotFoundError, ValueError) as exc:
            self.emitters = None
            self.error = str(exc)
            self.status = "compile error"
            return False

    def step_preview(self, frames: int = 30) -> None:
        """Run the compiled system from scratch and record alive counts."""
        if self.emitters is None:
            self.status = "fix compile errors first"
            return
        from lumixengine_tpu_torch.core import random as prng
        from lumixengine_tpu_torch.renderer.particle_system import ParticleSystem

        # preview at small caps: interactivity beats fidelity here
        try:
            sys_ = ParticleSystem(
                self.emitters,
                capacity_override={n: min(4096, max(c, 1)) for n, c in
                                   ParticleSystem(self.emitters).caps.items()})
            # declared globals preview as zeros (the game drives them live)
            dev = self.device
            system = {n: torch.zeros(w, device=dev) if w > 1
                      else torch.zeros((), device=dev)
                      for n, w in sys_.globals_decl.items()}
            system.setdefault("entity_position", torch.zeros(3, device=dev))
            states = sys_.device_state(dev, system=system)
            key = prng.PRNGKey(0, dev)
            self.history = {n: [] for n in sys_.order}
            t = 0.0
            for i in range(frames):
                key, k = prng.split(key)
                states = sys_.step(states, torch.tensor(1 / 60, dtype=torch.float32, device=dev),
                                   torch.tensor(t, dtype=torch.float32, device=dev), k,
                                   system=system)
                t += 1 / 60
                for n, c in sys_.alive_counts(states).items():
                    self.history[n].append(int(c))
            self.states = states
            self.status = f"previewed {frames} frames"
        except Exception as exc:   # surface trace/shape errors in the pane
            self.error = f"preview failed: {exc}"
            self.status = "preview error"

    # -- keys --------------------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        if self.edit is not None:
            if code == _ENTER:
                self.lines[self.sel] = self.edit
                self.edit = None
                self.compile()
            elif code == 27:
                self.edit = None
                self.status = "edit cancelled"
            elif code == 8:
                self.edit = self.edit[:-1]
            elif text and (text.isprintable() or text == "\t"):
                self.edit += text
            return
        if code == _UP:
            self.sel = max(0, self.sel - 1)
        elif code == _DOWN:
            self.sel = min(len(self.lines) - 1, self.sel + 1)
        elif code == _ENTER:
            self.edit = self.lines[self.sel]
        elif text == "a":
            self.lines.insert(self.sel + 1, "")
            self.sel += 1
            self.edit = ""
        elif text == "x" and self.lines:
            self.lines.pop(self.sel)
            self.sel = max(0, min(self.sel, len(self.lines) - 1))
            self.compile()
        elif text == "c":
            self.compile()
        elif text == "p":
            self.step_preview()
        elif text == "s":
            with open(self.path, "w") as f:
                f.write(self.source())
            self.status = f"saved {self.path}"

    # -- screen ------------------------------------------------------------

    def _right_rows(self, width: int) -> List[str]:
        rows: List[str] = []
        if self.error is not None:
            rows.append("COMPILE ERROR")
            for ln in self.error.splitlines():
                rows.append(" " + ln[: width - 1])
            return rows
        if self.emitters:
            for name, em in sorted(self.emitters.items()):
                d = em.decl
                cap = (d.max_ribbons * d.max_ribbon_length
                       if d.max_ribbons else d.max_particles)
                rows.append(f"emitter {name} cap={cap}")
                chans = ", ".join(f"{n}:{w}" for n, w in em.channels)
                if chans:
                    rows.append(f"  channels: {chans}"[: width])
                rows.append(f"  fns: {', '.join(sorted(d.fns))}"[: width])
                hist = self.history.get(name)
                if hist:
                    mx = max(max(hist), 1)
                    spark = "".join(
                        _SPARK[min(int(v / mx * (len(_SPARK) - 1)),
                                   len(_SPARK) - 1)] for v in hist[-40:])
                    rows.append(f"  alive {hist[-1]:6d} |{spark}|"[: width])
        return rows

    def render_text(self, width: int = 100, height: int = 28) -> str:
        self.sel = max(0, min(self.sel, max(len(self.lines) - 1, 0)))
        left_w = max(40, width * 3 // 5)
        right_w = width - left_w - 1
        body = height - 2
        t0 = max(0, self.sel - body + 1)
        lines = [f"particle editor — {os.path.basename(self.path)}"
                 .ljust(width)[:width]]
        right = self._right_rows(right_w)
        for r in range(body):
            li = t0 + r
            if li < len(self.lines):
                cur = ">" if li == self.sel else " "
                txt = (self.edit + "_" if (self.edit is not None
                                           and li == self.sel)
                       else self.lines[li])
                a = f"{cur}{li + 1:3d} {txt}"[:left_w].ljust(left_w)
            else:
                a = " " * left_w
            b = right[r][:right_w].ljust(right_w) if r < len(right) \
                else " " * right_w
            lines.append(a + "|" + b)
        lines.append(self.status.ljust(width)[:width])
        return "\n".join(lines)
