"""Animation controller graph editor view (counterpart of
``lumixengine_tpu/editor/anim_editor.py``; ≙ reference
animation/editor/controller_editor.cpp — there an ImGui node-graph canvas;
on this headless platform the graph is a navigable TREE pane with a live
preview pane, same editing core).

Three columns:
  * graph tree — the Controller's PoseNode hierarchy (Blend2D points,
    Select branches, clip leaves with slot names), selectable;
  * inputs — the controller's typed inputs with live values, editable
    (+/- nudge, enter to type a value);
  * preview — the controller stepped every frame at the current inputs:
    per-slot blend weights as bars, clip times, root clock.

Editing the slot→clip ENTRY table (retarget a slot to another clip path)
and renaming inputs edits the parsed .act header; 's' writes it back
through importers/act.write_act — unedited files round-trip byte-exact,
edits re-serialize the reference layout.

The preview steps ``Controller.eval`` with the inputs, the clocks and dt as
float32 tensors on the editor's `device` (the card unless the caller passes
a CPU device).

Keys: up/down select · tab cycle column · +/- nudge input · enter type a
value (inputs column) or a clip path (entries in the tree) · space
play/pause preview · s save .act · esc back.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_UP, _DOWN = 0x26, 0x28
_TAB = 9


def _node_label(node, statics=None) -> str:
    from lumixengine_tpu_torch.animation import controller as C

    kind = type(node).__name__
    if isinstance(node, C.AnimationNode):
        return f"clip #{node.clip}"
    if isinstance(node, C.Blend1D):
        return f"Blend1D over input[{getattr(node.value, 'index', '?')}]"
    if isinstance(node, C.Blend2D):
        return f"Blend2D ({len(node.points)} pts)"
    if isinstance(node, C.Select):
        return f"Select over input[{getattr(node.value, 'index', '?')}]"
    return kind


def _children(node) -> List[Any]:
    fn = getattr(node, "children_nodes", None)
    if fn is None:
        child = getattr(node, "child", None)
        return [child] if child is not None else []
    return list(fn())


class AnimGraphEditor:
    def __init__(self, controller, parsed: Optional[Dict[str, Any]] = None,
                 act_path: Optional[str] = None, device="cuda"):
        """`controller` is a built animation.controller.Controller;
        `parsed`/`act_path` (optional) attach the .act header for save;
        the preview evaluates on `device`."""
        self.ctrl = controller
        self.device = torch.device(device)
        self.parsed = parsed
        self.act_path = act_path
        self.col = "tree"            # tree | inputs | preview
        self.sel = 0
        self.input_sel = 0
        self.edit: Optional[str] = None
        self.playing = True
        self.status = "anim graph"
        self.inputs = np.zeros((controller.num_inputs, 1), np.float32)
        self.clocks = np.zeros((max(controller.num_clocks, 1), 1), np.float32)
        self._last_slots: List[Tuple] = []

    # -- graph flattening --------------------------------------------------

    def tree_rows(self) -> List[Tuple[int, str, Any]]:
        rows: List[Tuple[int, str, Any]] = []

        def walk(node, depth):
            rows.append((depth, _node_label(node), node))
            for ch in _children(node):
                walk(ch, depth + 1)

        walk(self.ctrl.root, 0)
        return rows

    # -- preview -----------------------------------------------------------

    def step_preview(self, dt: float = 1.0 / 30.0) -> None:
        if not self.playing:
            return
        dev = self.device
        slots, _masks, new_clocks = self.ctrl.eval(
            torch.as_tensor(self.inputs, device=dev), torch.as_tensor(self.clocks, device=dev),
            torch.tensor(dt, dtype=torch.float32, device=dev))
        if new_clocks.shape[0]:
            self.clocks = new_clocks.cpu().numpy()
        self._last_slots = [tuple(torch.as_tensor(v).reshape(-1)[0].item() for v in s)
                            for s in slots]

    # -- keys --------------------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        if self.edit is not None:
            if code == 13:
                self._commit_edit()
            elif code == 27:
                self.edit = None
                self.status = "edit cancelled"
            elif code == 8:
                self.edit = self.edit[:-1]
            elif text and text.isprintable():
                self.edit += text
            return
        if code == _TAB:
            order = ["tree", "inputs", "preview"]
            self.col = order[(order.index(self.col) + 1) % 3]
            self.status = f"{self.col} column"
        elif code == _UP:
            if self.col == "inputs":
                self.input_sel = max(0, self.input_sel - 1)
            else:
                self.sel = max(0, self.sel - 1)
        elif code == _DOWN:
            if self.col == "inputs":
                self.input_sel = min(self.ctrl.num_inputs - 1,
                                     self.input_sel + 1)
            else:
                self.sel = min(len(self.tree_rows()) - 1, self.sel + 1)
        elif text in ("+", "=") and self.col == "inputs":
            self.inputs[self.input_sel] += 0.5
            self.status = self._input_status()
        elif text == "-" and self.col == "inputs":
            self.inputs[self.input_sel] -= 0.5
            self.status = self._input_status()
        elif code == 13 and self.col == "inputs":
            self.edit = ""
            self.status = "type value, enter commits"
        elif text == " ":
            self.playing = not self.playing
            self.status = "playing" if self.playing else "paused"
        elif text == "s":
            self._save()

    def _input_status(self) -> str:
        nm = (self.ctrl.input_names[self.input_sel]
              if self.input_sel < len(self.ctrl.input_names) else "?")
        return f"{nm} = {float(self.inputs[self.input_sel, 0]):.2f}"

    def _commit_edit(self) -> None:
        try:
            self.inputs[self.input_sel] = float(self.edit or "0")
            self.status = self._input_status()
        except ValueError:
            self.status = f"not a number: {self.edit!r}"
        self.edit = None

    def retarget_entry(self, slot: int, animation: str) -> None:
        """Edit the .act header's slot→clip entry (≙ the controller editor's
        animation-slot assignment)."""
        if self.parsed is None:
            raise ValueError("no .act header attached")
        for e in self.parsed["entries"]:
            if e["slot"] == slot and e["set"] == 0:
                e["animation"] = animation
                self.status = f"slot {slot} -> {animation}"
                return
        self.parsed["entries"].append(
            {"slot": slot, "set": 0, "animation": animation})
        self.status = f"slot {slot} (new) -> {animation}"

    def _save(self) -> None:
        if self.parsed is None or self.act_path is None:
            self.status = "no .act attached (in-memory controller)"
            return
        from lumixengine_tpu_torch.importers.act import write_act

        blob = write_act(self.parsed)
        with open(self.act_path, "wb") as f:
            f.write(blob)
        self.status = f"saved {len(blob)} bytes -> {self.act_path}"

    # -- screen ------------------------------------------------------------

    def render_text(self, width: int = 100, height: int = 28) -> str:
        rows = self.tree_rows()
        self.sel = max(0, min(self.sel, len(rows) - 1))
        third = max(26, width // 3)
        body = height - 2
        lines = [f"anim graph — {self.ctrl.name} [{self.col.upper()}]"
                 .ljust(width)[:width]]
        tree_c: List[str] = []
        for i, (depth, label, _n) in enumerate(rows[:body]):
            cur = ">" if (i == self.sel and self.col == "tree") else " "
            tree_c.append(f"{cur}{'  ' * depth}{label}"[:third].ljust(third))
        in_c: List[str] = []
        for i, nm in enumerate(self.ctrl.input_names[:body]):
            cur = ">" if (i == self.input_sel and self.col == "inputs") else " "
            val = (self.edit + "_" if (self.edit is not None
                                       and i == self.input_sel)
                   else f"{float(self.inputs[i, 0]):.2f}")
            in_c.append(f"{cur}{nm} = {val}"[:third].ljust(third))
        pv_c: List[str] = [("playing" if self.playing else "paused")
                           .ljust(third)]
        for clip, t, wgt, _pt in self._last_slots[:body - 1]:
            bar = "#" * int(max(min(float(wgt), 1.0), 0.0) * 10)
            pv_c.append(f" clip {int(clip):3d} t={float(t):5.2f} "
                        f"w={float(wgt):.2f} {bar}"[:third].ljust(third))
        for r in range(body):
            a = tree_c[r] if r < len(tree_c) else " " * third
            b = in_c[r] if r < len(in_c) else " " * third
            c = pv_c[r] if r < len(pv_c) else " " * third
            lines.append((a + "|" + b + "|" + c)[:width].ljust(width))
        lines.append(self.status.ljust(width)[:width])
        return "\n".join(lines)
