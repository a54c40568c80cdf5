"""Material editor view (counterpart of
``lumixengine_tpu/editor/material_editor.py``; ≙ reference renderer/editor/render_plugins.cpp
MaterialPlugin::EditorWindow, :668-900 — there an ImGui asset window with
shader input, backface checkbox, layer combo, texture slots, uniform
widgets, and SimpleUndoRedo; here the same editable surface as a TUI over
the real `.mat` parser/writer (importers/mat.py), so every edit round-trips
the reference's on-disk format).

Rows: shader · backface_culling · layer · each define · each texture slot ·
each uniform / int_uniform. Keys: up/down select · enter edit the selected
row's value (enter commits, esc cancels) · b toggle backface · l cycle
layer · t append texture slot · d append define · u undo · y redo · s save.
The preview pane shows the ENGINE-side parameter block (MaterialRegistry
slots from to_material) — what draws will actually gather."""
from __future__ import annotations

import copy
import os
from typing import List, Optional, Tuple

_UP, _DOWN, _ENTER, _ESC = 0x26, 0x28, 13, 27
_LAYERS = ["default", "transparent", "decal", "ui"]


class MaterialEditor:
    def __init__(self, path: str, source: Optional[str] = None):
        from lumixengine_tpu_torch.importers.mat import parse_mat

        self.path = path
        if source is None:
            with open(path, "r", errors="replace") as f:
                source = f.read()
        self.mat = parse_mat(source)
        self.sel = 0
        self.edit: Optional[str] = None
        self.status = f"material editor — {os.path.basename(path)}"
        self.dirty = False
        self._undo: List = []
        self._redo: List = []

    # -- rows ----------------------------------------------------------------

    def rows(self) -> List[Tuple[str, str, str]]:
        """(kind, label, value) — kind keys the commit logic."""
        m = self.mat
        out = [("shader", "shader", m.shader),
               ("backface", "backface_culling",
                "true" if m.backface_culling else "false"),
               ("layer", "layer", m.layer)]
        out += [(f"define:{i}", f"define[{i}]", d)
                for i, d in enumerate(m.defines)]
        out += [(f"texture:{i}", f"texture[{i}]", t or '""')
                for i, t in enumerate(m.textures)]
        out += [(f"uniform:{n}", f'uniform "{n}"',
                 "{ " + ", ".join(f"{x:g}" for x in v) + " }"
                 if isinstance(v, tuple) else f"{v:g}")
                for n, v in m.uniforms.items()]
        out += [(f"int_uniform:{n}", f'int_uniform "{n}"', str(v))
                for n, v in m.int_uniforms.items()]
        return out

    # -- undo/redo (≙ SimpleUndoRedo in the reference window) -----------------

    def _push_undo(self) -> None:
        self._undo.append(copy.deepcopy(self.mat))
        self._redo.clear()
        self.dirty = True

    def undo(self) -> None:
        if self._undo:
            self._redo.append(self.mat)
            self.mat = self._undo.pop()
            self.status = "undo"

    def redo(self) -> None:
        if self._redo:
            self._undo.append(self.mat)
            self.mat = self._redo.pop()
            self.status = "redo"

    # -- edits ------------------------------------------------------------------

    def _commit(self, value: str) -> None:
        from lumixengine_tpu_torch.importers.mat import _parse_value

        kind = self.rows()[self.sel][0]
        self._push_undo()
        m = self.mat
        try:
            if kind == "shader":
                m.shader = value.strip().strip('"')
            elif kind == "backface":
                m.backface_culling = value.strip().lower() in ("true", "1")
            elif kind == "layer":
                m.layer = value.strip().strip('"')
            elif kind.startswith("define:"):
                i = int(kind.split(":", 1)[1])
                if value.strip():
                    m.defines[i] = value.strip().strip('"')
                else:
                    del m.defines[i]
            elif kind.startswith("texture:"):
                m.textures[int(kind.split(":", 1)[1])] = \
                    value.strip().strip('"')
            elif kind.startswith("uniform:"):
                m.uniforms[kind.split(":", 1)[1]] = _parse_value(value)
            elif kind.startswith("int_uniform:"):
                m.int_uniforms[kind.split(":", 1)[1]] = \
                    int(float(value.strip()))
            self.status = "edited"
        except (ValueError, IndexError) as exc:
            self.mat = self._undo.pop()     # reject the bad edit
            self.dirty = bool(self._undo)
            self.status = f"bad value: {exc}"

    def save(self) -> None:
        from lumixengine_tpu_torch.importers.mat import write_mat

        with open(self.path, "w") as f:
            f.write(write_mat(self.mat))
        self.dirty = False
        self.status = f"saved {self.path}"

    # -- keys ---------------------------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        if self.edit is not None:
            if code == _ENTER:
                v, self.edit = self.edit, None
                self._commit(v)
            elif code == _ESC:
                self.edit = None
                self.status = "edit cancelled"
            elif code == 8:
                self.edit = self.edit[:-1]
            elif text:
                self.edit += text
            return
        n = len(self.rows())
        ch = text.lower()
        if code == _UP:
            self.sel = max(self.sel - 1, 0)
        elif code == _DOWN:
            self.sel = min(self.sel + 1, n - 1)
        elif code == _ENTER:
            self.edit = ""
            self.status = "editing — enter commits, esc cancels"
        elif ch == "b":
            self._push_undo()
            self.mat.backface_culling = not self.mat.backface_culling
            self.status = f"backface_culling {self.mat.backface_culling}"
        elif ch == "l":
            self._push_undo()
            try:
                i = _LAYERS.index(self.mat.layer)
            except ValueError:
                i = -1
            self.mat.layer = _LAYERS[(i + 1) % len(_LAYERS)]
            self.status = f"layer {self.mat.layer}"
        elif ch == "t":
            self._push_undo()
            self.mat.textures.append("")
            self.status = "texture slot appended"
        elif ch == "d":
            self._push_undo()
            self.mat.defines.append("NEW_DEFINE")
            self.status = "define appended"
        elif ch == "u":
            self.undo()
        elif ch == "y":
            self.redo()
        elif ch == "s":
            self.save()

    # -- render ------------------------------------------------------------------

    def render_text(self, width: int = 100, height: int = 28) -> str:
        from lumixengine_tpu_torch.importers.mat import to_material

        rows = self.rows()
        self.sel = max(0, min(self.sel, len(rows) - 1))
        body = height - 3
        t0 = max(0, self.sel - body + 1)
        mark_dirty = " *" if self.dirty else ""
        lines = [f"material editor — {os.path.basename(self.path)}"
                 f"{mark_dirty}".ljust(width)[:width]]
        # engine-side preview: the parameter block draws will gather
        eng = to_material(os.path.basename(self.path), self.mat)
        prev = (f"engine: layer={eng.layer} alpha={eng.alpha_blend} "
                + " ".join(f"{k}={v:g}" for k, v in
                           sorted(eng.uniforms.items())))
        left_w = max(30, width * 2 // 3)
        for r in range(body):
            i = t0 + r
            if i < len(rows):
                kind, label, value = rows[i]
                cur = i == self.sel
                val = (self.edit + "_") if (cur and self.edit is not None) \
                    else value
                lt = f"{'>' if cur else ' '}{label} = {val}"
            else:
                lt = ""
            rt = prev[(r * max(width - left_w - 2, 1)):
                      ((r + 1) * max(width - left_w - 2, 1))] if r < 4 else ""
            lines.append((lt.ljust(left_w)[:left_w] + "| " + rt)
                         [:width].ljust(width))
        lines.append((f"[{self.status}]  keys: enter edit · b backface · "
                      "l layer · t +texture · d +define · u/y undo/redo · "
                      "s save")[:width].ljust(width))
        return "\n".join(lines[:height])
