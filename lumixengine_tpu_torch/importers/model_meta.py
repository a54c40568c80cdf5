"""Per-asset model import meta (counterpart of
``lumixengine_tpu/importers/model_meta.py``; ≙ reference renderer/editor/model_meta.h —
the `.meta` sidecar the editor writes next to each .fbx: physics cooking
mode, origin rebase, import scale, culling scale, LOD count/distances,
animation splits). Byte-compatible with the reference's Lua-ish `key =
value` text (model_meta.h serialize/deserialize: `physics = "convex"`,
`scale = 1.5`, `lod0_distance = 10`, booleans as true/false), so reference
.meta files drive this importer unchanged.

The AssetCompiler plugin registered by `register()` compiles `.fbx` with
its sidecar honored and re-compiles when either file changes."""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

MAX_LODS = 4


@dataclass
class ModelMeta:
    physics: str = "none"          # none | convex | trimesh
    origin: str = "source"         # source | center | center_xz | bottom
    scene_scale: float = 1.0       # serialized as `scale`
    culling_scale: float = 1.0
    lod_count: int = 1
    lods_distances: np.ndarray = field(
        default_factory=lambda: np.full(MAX_LODS, -1.0, np.float32))
    split: bool = False
    ignore_animations: bool = False
    create_impostor: bool = False

    def serialize(self) -> str:
        """Reference-compatible text (model_meta.h:74-147 write rules:
        non-default fields only)."""
        out = []
        if self.physics != "none":
            out.append(f'physics = "{self.physics}"')
        if self.origin != "source":
            out.append(f'origin = "{self.origin}"')
        out.append(f"lod_count = {self.lod_count}")
        for name, val in (("split", self.split),
                          ("ignore_animations", self.ignore_animations),
                          ("create_impostor", self.create_impostor)):
            if val:
                out.append(f"{name} = true")
        if self.scene_scale != 1.0:
            out.append(f"scale = {self.scene_scale}")
        if self.culling_scale != 1.0:
            out.append(f"culling_scale = {self.culling_scale}")
        for i in range(MAX_LODS):
            if self.lods_distances[i] > 0:
                out.append(f"lod{i}_distance = {float(self.lods_distances[i])}")
        return "\n".join(out) + "\n"


_LINE = re.compile(r'^\s*(\w+)\s*=\s*(.+?)\s*,?\s*$')


def parse_meta(text: str) -> ModelMeta:
    m = ModelMeta()
    for line in text.splitlines():
        mt = _LINE.match(line)
        if not mt:
            continue
        key, raw = mt.group(1), mt.group(2)
        val: object
        if raw.startswith('"'):
            val = raw.strip('"')
        elif raw in ("true", "false"):
            val = raw == "true"
        else:
            try:
                val = float(raw)
            except ValueError:
                continue
        if key == "physics" and val in ("none", "convex", "trimesh"):
            m.physics = str(val)
        elif key == "origin" and val in ("source", "center", "center_xz",
                                         "bottom"):
            m.origin = str(val)
        elif key == "scale":
            m.scene_scale = float(val)
        elif key == "culling_scale":
            m.culling_scale = float(val)
        elif key == "lod_count":
            m.lod_count = int(val)
        elif key in ("split", "ignore_animations", "create_impostor"):
            setattr(m, key, bool(val))
        else:
            lm = re.fullmatch(r"lod(\d)_distance", key)
            if lm:
                m.lods_distances[int(lm.group(1))] = float(val)
    return m


def meta_path(asset_path: str) -> str:
    return asset_path + ".meta"


def load_meta_for(asset_path: str) -> ModelMeta:
    """Meta sidecar next to the asset (≙ AssetCompiler::getMeta reading
    `<path>.meta`); missing file = all defaults."""
    p = meta_path(asset_path)
    try:
        with open(p, "r", encoding="utf-8", errors="replace") as f:
            return parse_meta(f.read())
    except OSError:
        return ModelMeta()


def apply_meta(model, meta: ModelMeta):
    """Bake the meta into an imported Model IN PLACE: import scale, origin
    rebase (unskinned models — the reference bakes origin into vertices the
    same way), culling scale, LOD switch distances. Returns the model."""
    if model.vertex_positions is None:
        return model
    vp = np.asarray(model.vertex_positions, np.float32)
    if meta.scene_scale != 1.0:
        vp = vp * np.float32(meta.scene_scale)
        if model.skeleton is not None:
            model.skeleton.bind_pos = (
                np.asarray(model.skeleton.bind_pos, np.float32)
                * np.float32(meta.scene_scale))
    if meta.origin != "source" and model.skeleton is None:
        mn, mx = vp.min(axis=0), vp.max(axis=0)
        c = (mn + mx) * 0.5
        if meta.origin == "center":
            off = c
        elif meta.origin == "center_xz":
            off = np.array([c[0], 0.0, c[2]], np.float32)
        else:                                  # bottom: feet at y=0
            off = np.array([c[0], mn[1], c[2]], np.float32)
        vp = vp - off
    model.vertex_positions = vp
    radius = float(np.linalg.norm(vp, axis=1).max()) if len(vp) else 1.0
    model.bounding_radius = max(radius, 1e-3) * float(meta.culling_scale)
    lods = np.full(MAX_LODS, np.inf, np.float32)
    for i in range(min(meta.lod_count, MAX_LODS)):
        d = float(meta.lods_distances[i])
        if d > 0:
            lods[i] = d
    model.lod_distances = lods
    return model


def compile_fbx(path: str, src: bytes, compiler=None):
    """AssetCompiler plugin: .fbx + sidecar meta → {model, meta, physics}.
    physics = cooked collision per the meta's physics mode (≙ FBXImporter
    writing .phy when ModelMeta::physics != NONE)."""
    from lumixengine_tpu_torch.importers import fbx as F

    meta = load_meta_for(path)
    doc = src if isinstance(src, F.FbxDoc) else F.FbxDoc(F.parse_fbx(src))
    model = F.to_model(doc, name=os.path.basename(path))
    apply_meta(model, meta)
    phys = None
    if meta.physics == "convex" and model.vertex_positions is not None:
        from lumixengine_tpu_torch.physics.cooking import cook_convex_cached
        phys = ("convex", cook_convex_cached(model.vertex_positions))
    elif meta.physics == "trimesh" and model.vertex_triangles is not None:
        # trimesh cooking is SDF-grid based and slow — defer to first use;
        # record the request so PhysicsModule cooks it on actor creation
        phys = ("trimesh", None)
    return {"model": model, "meta": meta, "physics": phys}


def register(compiler) -> None:
    """Register the .fbx plugin; meta edits recompile the model
    (registerDependency on the sidecar)."""
    def _fn(path, src):
        out = compile_fbx(path, src)
        compiler.register_dependency(path, meta_path(path))
        return out

    compiler.add_plugin("fbx", _fn)
