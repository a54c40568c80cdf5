"""Spline editor view (counterpart of
``lumixengine_tpu/editor/spline_editor.py``; ≙ reference editor/spline_editor.cpp:1-279 — a
MousePlugin + PropertyGrid plugin: alt-click appends a point, clicking a
point gizmo selects it, drag moves it, "Delete node" removes it, every
mutation goes through an undoable setSplinePoints command).

TUI surface over the same model: a point table for the selected spline
entity (CoreModule.splines), coordinate edits through the key machine,
append/delete/nudge — each mutation a SetSplinePointsCommand on the
EditorApp's undo stack (continuous nudges merge like the reference's
recordUndo ids) — and `overlay_segments` draws the polyline + point
markers over the scene view's presented frame."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from lumixengine_tpu_torch.editor.commands import SetSplinePointsCommand

_UP, _DOWN, _ENTER, _ESC = 0x26, 0x28, 13, 27
_NUDGE = {"i": (0.0, 0.0, -1.0), "k": (0.0, 0.0, 1.0),
          "j": (-1.0, 0.0, 0.0), "l": (1.0, 0.0, 0.0),
          "o": (0.0, 1.0, 0.0), "u": (0.0, -1.0, 0.0)}


class SplineEditor:
    def __init__(self, engine, world, stack):
        self.engine = engine
        self.world = world
        self.stack = stack
        self.core = world.modules["core"]
        self.sel_spline = 0                  # index into spline entities
        self.sel_point = 0
        self.edit: Optional[str] = None
        self.nudge_step = 0.5
        self.status = "spline editor"

    # -- model ------------------------------------------------------------------

    def spline_entities(self) -> List[int]:
        return sorted(self.core.splines.keys())

    def entity(self) -> int:
        ents = self.spline_entities()
        if not ents:
            return -1
        self.sel_spline = max(0, min(self.sel_spline, len(ents) - 1))
        return ents[self.sel_spline]

    def points(self) -> np.ndarray:
        e = self.entity()
        return (self.core.splines[e] if e >= 0
                else np.zeros((0, 3), np.float32))

    def world_points(self) -> np.ndarray:
        """Points are entity-local (≙ spline gizmos drawn at tr.pos +
        point, spline_editor.cpp:212-218)."""
        e = self.entity()
        if e < 0:
            return np.zeros((0, 3), np.float32)
        origin = np.asarray(self.world.get_local_transform(e)[0], np.float32)
        return self.points() + origin

    # -- edits (every mutation is one undoable command) ----------------------------

    def _set(self, pts: np.ndarray, merge_id: Optional[int] = None) -> None:
        e = self.entity()
        if e >= 0:
            self.stack.execute(SetSplinePointsCommand(e, pts,
                                                      merge_id=merge_id))

    def append_point(self) -> None:
        pts = self.points()
        new = (pts[-1] + [1.0, 0.0, 0.0] if len(pts)
               else np.zeros(3, np.float32))
        self._set(np.vstack([pts, new[None]]))
        self.sel_point = len(pts)
        self.status = f"point {self.sel_point} appended"

    def delete_point(self) -> None:
        pts = self.points()
        if not len(pts):
            return
        i = min(self.sel_point, len(pts) - 1)
        self._set(np.delete(pts, i, axis=0))
        self.sel_point = max(0, i - 1)
        self.status = f"point {i} deleted"

    def nudge(self, d: Tuple[float, float, float]) -> None:
        pts = self.points().copy()
        if not len(pts):
            return
        i = min(self.sel_point, len(pts) - 1)
        pts[i] += np.asarray(d, np.float32) * self.nudge_step
        # merge key = (point index): a run of nudges on one point is ONE
        # undo step (≙ recordUndo(id) merging during drags)
        self._set(pts, merge_id=i)
        p = pts[i]
        self.status = f"point {i} → ({p[0]:.2f}, {p[1]:.2f}, {p[2]:.2f})"

    def _commit_edit(self, text: str) -> None:
        try:
            vals = [float(x) for x in text.replace(",", " ").split()]
            if len(vals) != 3:
                raise ValueError("need x y z")
        except ValueError as exc:
            self.status = f"bad point: {exc}"
            return
        pts = self.points().copy()
        if not len(pts):
            return
        i = min(self.sel_point, len(pts) - 1)
        pts[i] = vals
        self._set(pts)
        self.status = f"point {i} set"

    # -- scene-view overlay -----------------------------------------------------

    def overlay_segments(self):
        """Polyline (green) + per-point markers (selected = yellow) in world
        space — consumed by SceneView.overlays."""
        wp = self.world_points()
        segs = []
        for a, b in zip(wp[:-1], wp[1:]):
            segs.append((a, b, (60, 220, 60)))
        s = 0.25
        for i, p in enumerate(wp):
            rgb = (250, 220, 40) if i == min(self.sel_point,
                                             max(len(wp) - 1, 0)) \
                else (220, 220, 220)
            segs.append((p - [s, 0, 0], p + [s, 0, 0], rgb))
            segs.append((p - [0, s, 0], p + [0, s, 0], rgb))
        return segs

    # -- keys --------------------------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        if self.edit is not None:
            if code == _ENTER:
                v, self.edit = self.edit, None
                self._commit_edit(v)
            elif code == _ESC:
                self.edit = None
            elif code == 8:
                self.edit = self.edit[:-1]
            elif text:
                self.edit += text
            return
        ch = text.lower()
        npts = len(self.points())
        if code == _UP:
            self.sel_point = max(self.sel_point - 1, 0)
        elif code == _DOWN:
            self.sel_point = min(self.sel_point + 1, max(npts - 1, 0))
        elif code == 9:                      # tab: next spline entity
            self.sel_spline += 1
            self.sel_point = 0
        elif code == _ENTER and npts:
            self.edit = ""
            self.status = "type x y z — enter commits"
        elif ch == "a":
            self.append_point()
        elif ch == "x":
            self.delete_point()
        elif ch in _NUDGE:
            self.nudge(_NUDGE[ch])
        elif ch == "+":
            self.nudge_step *= 2.0
            self.status = f"nudge step {self.nudge_step:g}"
        elif ch == "-":
            self.nudge_step = max(self.nudge_step * 0.5, 0.015625)
            self.status = f"nudge step {self.nudge_step:g}"

    # -- render ------------------------------------------------------------------

    def render_text(self, width: int = 100, height: int = 28) -> str:
        ents = self.spline_entities()
        e = self.entity()
        pts = self.points()
        seg = np.linalg.norm(np.diff(pts, axis=0), axis=-1) if len(pts) > 1 \
            else np.zeros(0)
        name = self.world.get_entity_name(e) if e >= 0 else "none"
        lines = [(f"spline editor — {len(ents)} spline(s), entity "
                  f"{e} ({name}), {len(pts)} points, "
                  f"length {seg.sum():.2f}").ljust(width)[:width]]
        body = height - 2
        t0 = max(0, self.sel_point - body + 1)
        for i in range(t0, min(t0 + body, len(pts))):
            cur = i == self.sel_point
            val = (self.edit + "_") if (cur and self.edit is not None) \
                else (f"({pts[i][0]:8.3f}, {pts[i][1]:8.3f}, "
                      f"{pts[i][2]:8.3f})")
            d = f"  seg {seg[i]:.2f}" if i < len(seg) else ""
            lines.append(f"{'>' if cur else ' '}[{i:3d}] {val}{d}"
                         [:width].ljust(width))
        while len(lines) < height - 1:
            lines.append("".ljust(width))
        lines.append((f"[{self.status}]  keys: a append · x delete · "
                      "enter edit xyz · ijkl/uo nudge · +/- step · "
                      "tab next spline")[:width].ljust(width))
        return "\n".join(lines[:height])
