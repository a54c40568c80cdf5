"""Model-import meta editor (counterpart of
``lumixengine_tpu/editor/meta_editor.py``; ≙ reference renderer/editor/model_importer.cpp
import UI + model_meta.h — per-asset import settings: physics cooking mode,
origin fixup, scales, LOD count/distances, flags — persisted as the `.meta`
sidecar next to the source asset and honored by the AssetCompiler).

TUI surface over importers/model_meta.py: typed rows (enums cycle on enter,
bools toggle, numbers edit through the key machine), 's' writes the
reference-compatible sidecar and recompiles the asset when a compiler is
attached, so the edit lands in the import pipeline immediately."""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

_UP, _DOWN, _ENTER, _ESC = 0x26, 0x28, 13, 27
_PHYSICS = ["none", "convex", "trimesh"]
_ORIGIN = ["source", "center", "center_xz", "bottom"]


class MetaEditor:
    def __init__(self, asset_path: str, compiler=None):
        from lumixengine_tpu_torch.importers.model_meta import (load_meta_for,
                                                          meta_path)

        self.asset_path = asset_path
        self.meta_file = meta_path(asset_path)
        self.meta = load_meta_for(asset_path)
        self.compiler = compiler
        self.sel = 0
        self.edit: Optional[str] = None
        self.dirty = False
        self.status = f"meta editor — {os.path.basename(asset_path)}"

    # -- rows -----------------------------------------------------------------

    def rows(self) -> List[Tuple[str, str]]:
        m = self.meta
        out = [("physics", m.physics), ("origin", m.origin),
               ("scale", f"{m.scene_scale:g}"),
               ("culling_scale", f"{m.culling_scale:g}"),
               ("lod_count", str(m.lod_count)),
               ("split", str(m.split).lower()),
               ("ignore_animations", str(m.ignore_animations).lower()),
               ("create_impostor", str(m.create_impostor).lower())]
        out += [(f"lod{i}_distance", f"{float(m.lods_distances[i]):g}")
                for i in range(len(m.lods_distances))]
        return out

    def _apply(self, key: str, text: str) -> None:
        m = self.meta
        try:
            if key == "scale":
                m.scene_scale = float(text)
            elif key == "culling_scale":
                m.culling_scale = float(text)
            elif key == "lod_count":
                m.lod_count = max(1, min(int(float(text)),
                                         len(m.lods_distances)))
            elif key.startswith("lod"):
                m.lods_distances[int(key[3])] = float(text)
            else:
                raise ValueError(key)
            self.dirty = True
            self.status = f"{key} = {text}"
        except (ValueError, IndexError) as exc:
            self.status = f"bad value: {exc}"

    def save(self) -> None:
        with open(self.meta_file, "w") as f:
            f.write(self.meta.serialize())
        self.dirty = False
        self.status = f"saved {self.meta_file}"
        if self.compiler is not None:
            try:                # recompile so the edit lands immediately
                self.compiler.compile(self.asset_path)
                self.status += " (recompiled)"
            except Exception as exc:
                self.status += f" (recompile failed: {exc})"

    # -- keys --------------------------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        rows = self.rows()
        self.sel = max(0, min(self.sel, len(rows) - 1))
        key = rows[self.sel][0]
        if self.edit is not None:
            if code == _ENTER:
                v, self.edit = self.edit, None
                self._apply(key, v)
            elif code == _ESC:
                self.edit = None
            elif code == 8:
                self.edit = self.edit[:-1]
            elif text:
                self.edit += text
            return
        ch = text.lower()
        if code == _UP:
            self.sel = max(self.sel - 1, 0)
        elif code == _DOWN:
            self.sel = min(self.sel + 1, len(rows) - 1)
        elif code == _ENTER:
            m = self.meta
            if key == "physics":            # enums cycle like a combo
                m.physics = _PHYSICS[(_PHYSICS.index(m.physics) + 1)
                                     % len(_PHYSICS)]
                self.dirty = True
                self.status = f"physics = {m.physics}"
            elif key == "origin":
                m.origin = _ORIGIN[(_ORIGIN.index(m.origin) + 1)
                                   % len(_ORIGIN)]
                self.dirty = True
                self.status = f"origin = {m.origin}"
            elif key in ("split", "ignore_animations", "create_impostor"):
                setattr(m, key, not getattr(m, key))
                self.dirty = True
                self.status = f"{key} = {getattr(m, key)}"
            else:
                self.edit = ""
                self.status = "editing — enter commits, esc cancels"
        elif ch == "s":
            self.save()

    # -- render ------------------------------------------------------------------

    def render_text(self, width: int = 100, height: int = 28) -> str:
        rows = self.rows()
        self.sel = max(0, min(self.sel, len(rows) - 1))
        star = " *" if self.dirty else ""
        lines = [(f"model meta — {os.path.basename(self.asset_path)}{star} "
                  f"({self.meta_file})").ljust(width)[:width]]
        body = height - 2
        t0 = max(0, self.sel - body + 1)
        for i in range(t0, min(t0 + body, len(rows))):
            k, v = rows[i]
            cur = i == self.sel
            val = (self.edit + "_") if (cur and self.edit is not None) else v
            lines.append(f"{'>' if cur else ' '}{k} = {val}"
                         [:width].ljust(width))
        while len(lines) < height - 1:
            lines.append("".ljust(width))
        lines.append((f"[{self.status}]  keys: enter edit/cycle/toggle · "
                      "s save+recompile")[:width].ljust(width))
        return "\n".join(lines[:height])
