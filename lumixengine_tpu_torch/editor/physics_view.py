"""Physics editor view (counterpart of
``lumixengine_tpu/editor/physics_view.py``; ≙ reference physics/editor/physics_plugins.cpp:1-1045
— there ImGui joint gizmos drawn with addLine/addSphere plus a collision-layer
matrix editor; here the same capabilities as a TUI view + scene-view overlay).

Two modes:
  * joints — every joint in the world as a table (type, bodies, anchors,
    axis, limits, drive), plus `overlay_segments()`: world-space line
    segments for the selected (or all) joints — anchor frames as RGB axis
    triads and a grey body-to-body link, exactly the reference's
    showD6JointGizmo/showHingeJointGizmo visual language
    (physics_plugins.cpp:42-134). The SceneView draws these over its
    presented frame.
  * layers — the 32×32 collision-layer matrix (≙ PhysicsSystem layer
    editor): cursor + space toggles a pair (symmetric, through
    PhysicsSystem.set_layers_collide), 'n' renames the cursor's row layer.
    Matrix + names persist through world save (PhysicsModule.serialize).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from lumixengine_tpu_torch.core import host_math as hm

_UP, _DOWN, _LEFT, _RIGHT = 0x26, 0x28, 0x25, 0x27

JOINT_TYPE_NAMES = {0: "distance", 1: "spherical", 2: "hinge", 3: "d6"}

_AXIS_COLORS = ((220, 60, 60), (60, 200, 60), (70, 110, 230))  # X Y Z
_LINK_COLOR = (130, 130, 130)


class PhysicsView:
    def __init__(self, engine, world):
        self.engine = engine
        self.world = world
        self.mode = "joints"            # "joints" | "layers"
        self.sel = 0                    # joint row cursor
        self.cur = [0, 0]               # layer matrix cursor (row, col)
        self.edit: Optional[str] = None  # layer-name edit buffer
        self.status = "physics view"
        self.show_all_gizmos = True

    # -- model -----------------------------------------------------------------

    @property
    def module(self):
        return self.world.modules.get("physics")

    @property
    def system(self):
        m = self.module
        return getattr(m, "system", None) if m is not None else None

    def joint_rows(self) -> List[dict]:
        m = self.module
        if m is None:
            return []
        j = m.joints
        rows = []
        for slot in range(j.capacity):
            e = int(j.entity[slot])
            if e < 0:
                continue
            d = j.data
            rows.append({
                "entity": e,
                "type": JOINT_TYPE_NAMES.get(int(d["jtype"][slot]), "?"),
                "ent_a": int(d["ent_a"][slot]),
                "ent_b": int(d["ent_b"][slot]),
                "anchor_a": d["anchor_a"][slot].copy(),
                "anchor_b": d["anchor_b"][slot].copy(),
                "axis": d["axis"][slot].copy(),
                "limit_on": int(d["limit_on"][slot]),
                "limit": (float(d["limit_min"][slot]),
                          float(d["limit_max"][slot])),
                "drive_on": int(d["drive_on"][slot]),
                "length": float(d["length"][slot]),
            })
        return rows

    def layer_names(self) -> List[str]:
        sys = self.system
        if sys is None:
            return []
        if not hasattr(sys, "layer_names"):
            sys.layer_names = [f"layer{i}" for i in range(
                sys.layer_matrix.shape[0])]
            sys.layer_names[0] = "default"
        return sys.layer_names

    def used_layers(self) -> int:
        """Rows shown: every layer referenced by an actor, +2 spare, min 8."""
        m = self.module
        hi = 0
        if m is not None and len(m.actors):
            used = m.actors.data["layer"][m.actors.entity >= 0]
            if used.size:
                hi = int(used.max())
        return max(8, hi + 2)

    # -- joint gizmos (scene-view overlay) ---------------------------------------

    def overlay_segments(self) -> List[Tuple[np.ndarray, np.ndarray, tuple]]:
        """World-space (p0, p1, rgb) segments for joint visualization
        (≙ physics_plugins.cpp addLine gizmos: RGB triad at each anchor
        frame, grey link between the bodies, axis emphasized for hinges)."""
        segs = []          # triads/axes — drawn LAST (on top of the links)
        links = []
        rows = self.joint_rows()
        if not self.show_all_gizmos and rows:
            self.sel = max(0, min(self.sel, len(rows) - 1))
            rows = [rows[self.sel]]
        for r in rows:
            for end, ent in (("anchor_a", r["ent_a"]), ("anchor_b", r["ent_b"])):
                if ent < 0 or not self.world.is_alive(ent):
                    continue
                pos, rot, _ = self.world.get_global_transform(ent)
                anchor = pos + hm.quat_rotate(rot[None],
                                              r[end][None].astype(np.float32))[0]
                for ax in range(3):
                    v = np.zeros(3, np.float32)
                    v[ax] = 0.5
                    tip = anchor + hm.quat_rotate(rot[None], v[None])[0]
                    segs.append((anchor, tip, _AXIS_COLORS[ax]))
                if r["type"] == "hinge" and end == "anchor_a":
                    ax_w = hm.quat_rotate(
                        rot[None], r["axis"][None].astype(np.float32))[0]
                    segs.append((anchor - ax_w, anchor + ax_w, (230, 200, 60)))
            a, b = r["ent_a"], r["ent_b"]
            if (a >= 0 and b >= 0 and self.world.is_alive(a)
                    and self.world.is_alive(b)):
                pa = self.world.get_global_transform(a)[0]
                pb = self.world.get_global_transform(b)[0]
                links.append((pa, pb, _LINK_COLOR))
        return links + segs

    # -- key handling -------------------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        if self.edit is not None:
            if code == 13:                     # commit rename
                names = self.layer_names()
                if names:
                    names[self.cur[0]] = self.edit or names[self.cur[0]]
                self.status = f"layer {self.cur[0]} renamed"
                self.edit = None
            elif code == 27:
                self.edit = None
                self.status = "rename cancelled"
            elif code == 8:
                self.edit = self.edit[:-1]
            elif text and (text.isalnum() or text in "_-"):
                self.edit += text
            return
        ch = text.lower()
        if ch == "m":
            self.mode = "layers" if self.mode == "joints" else "joints"
            self.status = f"{self.mode} mode"
        elif self.mode == "joints":
            n = len(self.joint_rows())
            if code == _UP:
                self.sel = max(self.sel - 1, 0)
            elif code == _DOWN:
                self.sel = min(self.sel + 1, max(n - 1, 0))
            elif ch == "g":
                self.show_all_gizmos = not self.show_all_gizmos
                self.status = ("gizmos: all joints" if self.show_all_gizmos
                               else "gizmos: selected joint")
        else:
            L = self.used_layers()
            if code == _UP:
                self.cur[0] = max(self.cur[0] - 1, 0)
            elif code == _DOWN:
                self.cur[0] = min(self.cur[0] + 1, L - 1)
            elif code == _LEFT:
                self.cur[1] = max(self.cur[1] - 1, 0)
            elif code == _RIGHT:
                self.cur[1] = min(self.cur[1] + 1, L - 1)
            elif text == " " or code == 13:
                sys = self.system
                if sys is not None:
                    a, b = self.cur
                    now = bool(sys.layer_matrix[a, b])
                    sys.set_layers_collide(a, b, not now)
                    if self.module is not None:
                        self.module.invalidate_statics()
                    self.status = (f"{self.layer_names()[a]} × "
                                   f"{self.layer_names()[b]}: "
                                   f"{'collide' if not now else 'ignore'}")
            elif ch == "n":
                self.edit = ""
                self.status = f"rename layer {self.cur[0]}: type + enter"

    # -- render ---------------------------------------------------------------------

    def render_text(self, width: int = 100, height: int = 28) -> str:
        lines = []
        if self.mode == "joints":
            rows = self.joint_rows()
            self.sel = max(0, min(self.sel, max(len(rows) - 1, 0)))
            lines.append(f"physics — joints ({len(rows)})  "
                         "[m layers · g gizmo scope · esc back]")
            lines.append("  type       entity  a→b      axis            "
                         "limit           drive/len")
            for i, r in enumerate(rows[: height - 4]):
                mark = ">" if i == self.sel else " "
                lim = (f"[{r['limit'][0]:.2f},{r['limit'][1]:.2f}]"
                       if r["limit_on"] else "—")
                drv = "drive" if r["drive_on"] else f"len {r['length']:.2f}"
                ax = "({:+.1f},{:+.1f},{:+.1f})".format(*r["axis"])
                lines.append(
                    f"{mark} {r['type']:<10} e{r['entity']:<5} "
                    f"{r['ent_a']}→{r['ent_b']:<5} {ax:<15} {lim:<15} {drv}")
            if not rows:
                lines.append("  (no joints in this world)")
        else:
            names = self.layer_names()
            L = self.used_layers()
            lines.append(f"physics — collision layers {L}×{L} shown  "
                         "[m joints · space toggle · n rename · esc back]")
            head = "            " + " ".join(f"{c:>2d}" for c in range(L))
            lines.append(head)
            sys = self.system
            for rname in range(L):
                cells = []
                for c in range(L):
                    on = bool(sys.layer_matrix[rname, c]) if sys else True
                    cell = "■" if on else "·"
                    if [rname, c] == self.cur:
                        cell = "X" if on else "o"
                    cells.append(f" {cell}")
                nm = (names[rname] if rname < len(names) else f"layer{rname}")
                if self.edit is not None and rname == self.cur[0]:
                    nm = self.edit + "_"
                lines.append(f"{nm[:10]:>10}: " + "".join(cells))
        lines.append(f"[{self.status}]")
        out = [ln.ljust(width)[:width] for ln in lines[:height]]
        return "\n".join(out)
