"""Asset browser (counterpart of
``lumixengine_tpu/editor/asset_browser.py``; ≙ reference editor/asset_browser.cpp:1-1509).

The reference's AssetBrowser lists every source asset under the project data
dirs, groups them by resource type (each editor plugin registers extensions),
shows per-asset details, and recompiles through the AssetCompiler. Same
surface here, terminal-grade: a scan of the data dirs into typed entries, a
filterable list view (pure state machine + text composer like EditorApp), a
lazy per-type inspector driven by the real importers, and recompile through
editor/asset_compiler.py when a plugin covers the extension.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

# extension → resource type (≙ each AssetBrowser plugin's
# getResourceType/acceptExtension registrations)
TYPE_OF_EXT = {
    ".fbx": "model",
    ".anm": "animation", ".ani": "animation",
    ".act": "anim_controller",
    ".anp": "property_animation",
    ".pat": "particle_script", ".pai": "particle_import",
    ".tga": "texture", ".raw": "texture", ".png": "texture",
    ".dds": "texture", ".jpg": "texture", ".ltc": "texture",
    ".wav": "audio",
    ".nav": "navzone",
    ".unv": "world",
    ".lua": "lua_script",
    ".mat": "material",
    ".shd": "shader", ".hlsl": "shader", ".inc": "shader",
    ".fab": "prefab",
    ".phy": "physics_geometry",
    ".sigh": "signal",
}


@dataclass
class AssetEntry:
    path: str        # data-dir-relative (the asset's logical path)
    full: str        # absolute path on disk
    type: str
    size: int
    mtime: float


class AssetBrowser:
    """Scan + filter + inspect + recompile. UI state machine mirrors
    EditorApp: handle_key() over render_text()."""

    def __init__(self, data_dirs: Tuple[str, ...], compiler=None):
        self.data_dirs = tuple(data_dirs)
        self.compiler = compiler          # editor.asset_compiler.AssetCompiler
        self.entries: List[AssetEntry] = []
        self.filter = ""
        self.sel = 0
        self.show_details = False
        self.status = ""
        self._details_cache: Dict[str, Dict[str, Any]] = {}
        self.scan()

    # -- model ---------------------------------------------------------------

    def scan(self) -> int:
        """Walk the data dirs → typed entries (≙ AssetBrowser scanning +
        AssetCompiler::onInitFinished directory walk)."""
        self.entries = []
        seen = set()
        for d in self.data_dirs:
            if not os.path.isdir(d):
                continue
            for root, _dirs, files in os.walk(d):
                for f in files:
                    ext = os.path.splitext(f)[1].lower()
                    t = TYPE_OF_EXT.get(ext)
                    if t is None:
                        continue
                    full = os.path.join(root, f)
                    rel = os.path.relpath(full, d).replace(os.sep, "/")
                    if rel in seen:
                        continue  # first data dir wins (mount order)
                    seen.add(rel)
                    try:
                        st = os.stat(full)
                    except OSError:
                        continue
                    self.entries.append(AssetEntry(
                        path=rel, full=full, type=t,
                        size=st.st_size, mtime=st.st_mtime))
        self.entries.sort(key=lambda e: (e.type, e.path))
        return len(self.entries)

    def visible(self) -> List[AssetEntry]:
        if not self.filter:
            return self.entries
        f = self.filter.lower()
        return [e for e in self.entries
                if f in e.path.lower() or f in e.type]

    def selected(self) -> Optional[AssetEntry]:
        vis = self.visible()
        if not vis:
            return None
        self.sel = max(0, min(self.sel, len(vis) - 1))
        return vis[self.sel]

    # -- inspection (lazy, cached, importer-driven) ----------------------------

    def details(self, entry: AssetEntry) -> Dict[str, Any]:
        """Per-type facts via the real importers (≙ each plugin's
        onGUI details pane). Never raises — inspection failures report."""
        if entry.full in self._details_cache:
            return self._details_cache[entry.full]
        out: Dict[str, Any] = {"type": entry.type,
                               "size": entry.size}
        try:
            out.update(self._inspect(entry))
        except Exception as ex:  # report like the reference's load errors
            out["error"] = f"{type(ex).__name__}: {ex}"
        self._details_cache[entry.full] = out
        return out

    def _inspect(self, entry: AssetEntry) -> Dict[str, Any]:
        t = entry.type
        if t == "model":
            from lumixengine_tpu_torch.importers import fbx

            doc = fbx.load_fbx(entry.full)
            models = doc.by_class.get("Model", [])
            geoms = doc.by_class.get("Geometry", [])
            stacks = doc.by_class.get("AnimationStack", [])
            return {"nodes": len(models), "geometries": len(geoms),
                    "animation_stacks": len(stacks)}
        if t == "animation":
            from lumixengine_tpu_torch.importers import anm

            with open(entry.full, "rb") as f:
                a = anm.decode_anm(f.read())
            return {"fps": a.fps, "frames": a.frame_count + 1,
                    "translation_tracks": len(a.translations),
                    "rotation_tracks": len(a.rotations),
                    "skeleton": a.skeleton}
        if t == "particle_script":
            from lumixengine_tpu_torch.renderer.particle_compiler import compile_source

            base = os.path.dirname(entry.full)

            def _resolve(path: str) -> str:
                for cand in (os.path.join(base, os.path.basename(path)),
                             os.path.join(base, path)):
                    if os.path.isfile(cand):
                        with open(cand, "r", errors="replace") as f:
                            return f.read()
                raise FileNotFoundError(path)

            with open(entry.full, "r", errors="replace") as f:
                emitters = compile_source(f.read(), resolve=_resolve)
            return {"emitters": sorted(emitters)}
        if t == "audio":
            import wave

            with wave.open(entry.full, "rb") as w:
                return {"channels": w.getnchannels(), "rate": w.getframerate(),
                        "seconds": round(w.getnframes()
                                         / max(w.getframerate(), 1), 3)}
        if t == "world":
            from lumixengine_tpu_torch.importers.unv import load_unv

            scene = load_unv(entry.full)
            return {"entities": len(scene.get("entities", [])),
                    "version": scene.get("version")}
        if t == "texture":
            from lumixengine_tpu_torch.renderer.texture import load_texture

            with open(entry.full, "rb") as f:
                tex = load_texture(entry.full, f.read())
            arr = getattr(tex, "data", tex)
            shape = getattr(arr, "shape", None)
            return {"shape": tuple(shape) if shape else "?"}
        if t == "anim_controller":
            with open(entry.full, "r", errors="replace") as f:
                src = f.read()
            return {"nodes": src.count("node"),
                    "inputs": src.count("input")}
        return {}

    # -- recompile -------------------------------------------------------------

    def recompile(self, entry: AssetEntry) -> str:
        """Recompile through the AssetCompiler (≙ "Recompile" context action →
        AssetCompiler::pushToCompileQueue)."""
        if self.compiler is None:
            return "no AssetCompiler attached"
        try:
            self.compiler.compile(entry.full)
        except KeyError:
            return f"no compile plugin for .{entry.path.rsplit('.', 1)[-1]}"
        except Exception as ex:
            return f"compile failed: {ex}"
        self._details_cache.pop(entry.full, None)
        return f"compiled {entry.path} (v{self.compiler.version(entry.full)})"

    # -- UI state machine -------------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        _UP, _DOWN = 0x26, 0x28
        if code == _UP:
            self.sel = max(self.sel - 1, 0)
        elif code == _DOWN:
            self.sel += 1
            self.selected()
        elif code == 13:                      # enter: toggle details pane
            self.show_details = not self.show_details
        elif code == 8:                       # backspace: edit filter
            self.filter = self.filter[:-1]
            self.sel = 0
        elif text == "!":                     # recompile selected
            e = self.selected()
            if e is not None:
                self.status = self.recompile(e)
        elif text == "*":                     # rescan
            self.status = f"rescanned: {self.scan()} assets"
        elif text == "@":                     # edit the model-import .meta
            e = self.selected()
            if e is not None and e.type == "model":
                # the shell (EditorApp) picks this up and opens the meta
                # editor view (≙ the reference model importer UI opening
                # from the asset browser's context menu)
                self.meta_request = e.full
                self.status = f"meta editor: {e.path}"
            else:
                self.status = "select a model to edit its .meta"
        elif text and (text.isalnum() or text in "._-/ "):
            self.filter += text
            self.sel = 0

    def render_text(self, width: int = 100, height: int = 28) -> str:
        vis = self.visible()
        sel = self.selected()
        body = height - 3
        t0 = max(0, self.sel - body + 1)
        lines = [f"asset browser — {len(vis)}/{len(self.entries)} assets"
                 f"  filter:[{self.filter}]".ljust(width)[:width]]
        left_w = max(40, (2 * width) // 3) if self.show_details else width
        det_lines: List[str] = []
        if self.show_details and sel is not None:
            det = self.details(sel)
            det_lines = [f"{k}: {v}" for k, v in det.items()]
        for r in range(body):
            i = t0 + r
            if i < len(vis):
                e = vis[i]
                mark = ">" if i == self.sel else " "
                lt = f"{mark}[{e.type:<16}] {e.path}  ({e.size}B)"
            else:
                lt = ""
            if self.show_details:
                rt = det_lines[r] if r < len(det_lines) else ""
                lines.append((lt.ljust(left_w)[:left_w] + "| " + rt)
                             [:width].ljust(width))
            else:
                lines.append(lt[:width].ljust(width))
        lines.append("-" * width)
        lines.append((f"[{self.status}]  keys: type=filter · enter details · "
                      "! recompile · * rescan")[:width].ljust(width))
        return "\n".join(lines[:height])
