"""Reference `.unv` world file WRITER — the save half of the importer
(counterpart of ``lumixengine_tpu/importers/unv_write.py``).

≙ the reference editor's world save (world.cpp:837-897 serialize + each
module's serialize: physics_module.cpp:3553-3599, render_module.cpp:962-1250,
animation_module.cpp:259-343, lua_script_system.cpp:1339-1510, core.cpp:33-48,
audio/navigation/gui module serialize). Mirrors `unv.py`'s parse branches
exactly, writing at the same world/module versions the scene dict was parsed
at, so content round-trips: ``parse(write(parse(f))) == parse(f)`` for every
shipped demo map.

One lossy-but-benign note: camera pad bytes at v <= POSTPROCESS write as
zeros (the parser discards them). Named partitions round-trip: the table
({u16 handle; char name[64]} records + u16 active) and per-entity tags.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List

import numpy as np

from lumixengine_tpu_torch.importers.unv import (
    MAGIC_LWRL, WV_COMPRESSED, WV_LATEST, _RMV, _LUA_TYPES)


class Writer:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts: List[bytes] = []

    def raw(self, b: bytes):
        self.parts.append(bytes(b))

    def _one(self, fmt: str, v):
        self.parts.append(struct.pack(fmt, v))

    def u8(self, v): self._one("<B", int(v))
    def b8(self, v): self._one("<B", 1 if v else 0)
    def i32(self, v): self._one("<i", int(v))
    def u32(self, v): self._one("<I", int(v))
    def u64(self, v): self._one("<Q", int(v))
    def f32(self, v): self._one("<f", float(v))
    def f64(self, v): self._one("<d", float(v))

    def fvec(self, fmt: str, v):
        self.parts.append(struct.pack(fmt, *[float(x) for x in v]))

    def vec2(self, v): self.fvec("<2f", v)
    def vec3(self, v): self.fvec("<3f", v)
    def vec4(self, v): self.fvec("<4f", v)
    def quat(self, v): self.fvec("<4f", v)
    def dvec3(self, v): self.fvec("<3d", v)

    def string(self, s: str):
        self.parts.append(str(s).encode("utf-8") + b"\0")

    def local_rigid_transform(self, t):
        self.vec3(t["pos"])
        self.quat(t["rot"])

    def rigid_transform(self, t):
        self.quat(t["rot"])
        self.dvec3(t["pos"])

    def px_transform(self, t):
        self.quat(t["rot"])
        self.vec3(t["pos"])

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


# ---------------------------------------------------------------------------
# per-module writers — exact mirrors of unv.py's parsers

def _write_physics(w: Writer, m: Dict[str, Any], version: int) -> None:
    w.u32(len(m["actors"]))
    for a in m["actors"]:
        w.i32(a["entity"])
        w.i32(a["dynamic_type"])
        w.b8(a["is_trigger"])
        if version > 6:
            w.b8(a.get("ccd", False))
        w.u32(a["layer"])
        if version > 5:
            w.string(a.get("material", ""))
        w.string(a.get("mesh", ""))
        w.i32(len(a["geoms"]))
        for g in a["geoms"]:
            w.i32(g["type"])
            w.i32(g["index"])
            w.rigid_transform(g["local"])
            if g["type"] == 0:
                w.f32(g["radius"])
            elif g["type"] == 3:
                w.vec3(g["half_extents"])
            elif g["type"] in (4, 5):
                pass
            else:
                raise ValueError(f"unv write: unknown px geom type {g['type']}")

    w.u32(len(m["controllers"]))
    for c in m["controllers"]:
        w.i32(c["entity"]); w.u32(c["layer"]); w.f32(c["radius"])
        w.f32(c["height"]); w.b8(c["custom_gravity"])
        w.f32(c["custom_gravity_acceleration"]); w.b8(c["use_root_motion"])

    w.u32(len(m["heightfields"]))
    for h in m["heightfields"]:
        w.i32(h["entity"]); w.string(h["heightmap"])
        w.f32(h["xz_scale"]); w.f32(h["y_scale"]); w.u32(h["layer"])

    if version <= 0:
        w.u32(0)

    if version > 3:
        w.i32(len(m["instanced_cubes"]))
        for ic in m["instanced_cubes"]:
            w.i32(ic["entity"]); w.vec3(ic["half_extents"]); w.u32(ic["layer"])
    if version > 4:
        w.i32(len(m["instanced_meshes"]))
        for im in m["instanced_meshes"]:
            w.i32(im["entity"]); w.string(im["mesh"]); w.u32(im["layer"])

    w.u32(len(m["joints"]))
    for j in m["joints"]:
        w.i32(j["entity"]); w.i32(j["px_type"]); w.i32(j["connected_body"])
        w.px_transform(j["local_frame0"])
        t = j["px_type"]
        if t == 256:      # spherical
            w.u32(j["flags"]); w.fvec("<7f", j["limit"])
        elif t == 257:    # revolute/hinge
            w.u32(j["flags"]); w.fvec("<7f", j["limit"])
        elif t == 260:    # distance
            w.u32(j["flags"])
            w.fvec("<5f", (j["damping"], j["stiffness"], j["tolerance"],
                           j["min_distance"], j["max_distance"]))
        elif t == 261:    # d6
            w.parts.append(struct.pack("<6i", *j["motions"]))
            w.fvec("<6f", j["linear_limit"])
            w.fvec("<7f", j["swing_limit"])
            w.fvec("<7f", j["twist_limit"])
        else:
            raise ValueError(f"unv write: unknown joint type {t}")

    w.u32(len(m["vehicles"]))
    for v in m["vehicles"]:
        w.i32(v["entity"]); w.f32(v["mass"]); w.vec3(v["center_of_mass"])
        w.f32(v["moi_multiplier"]); w.u32(v["chassis_layer"])
        w.u32(v["wheels_layer"])
        if version > 1:
            w.f32(v.get("peak_torque", 0.0))
        if version > 2:
            w.f32(v.get("max_rpm", 0.0))
        w.string(v.get("geom", ""))
    w.u32(len(m["wheels"]))
    for wh in m["wheels"]:
        w.i32(wh["entity"])
        w.fvec("<8f", (wh["mass"], wh["radius"], wh["width"], wh["moi"],
                       wh["max_droop"], wh["max_compression"],
                       wh["spring_strength"], wh["spring_damper_rate"]))
        w.i32(wh["slot"])


def _write_animation(w: Writer, m: Dict[str, Any], version: int) -> None:
    w.u32(len(m["animables"]))
    for a in m["animables"]:
        w.i32(a["entity"]); w.string(a["animation"])
    w.u32(len(m["property_animators"]))
    for a in m["property_animators"]:
        w.i32(a["entity"]); w.string(a["animation"]); w.u32(a["flags"])
    w.u32(len(m["animators"]))
    for a in m["animators"]:
        w.u32(a["default_set"]); w.i32(a["entity"])
        if version > 0:
            w.u32(a.get("flags", 0))
        w.string(a["controller"])


def _write_audio(w: Writer, m: Dict[str, Any], version: int) -> None:
    w.i32(m["listener"])
    if version < 1:
        w.i32(0)
    w.i32(len(m["ambient_sounds"]))
    for s in m["ambient_sounds"]:
        w.string(s["clip"]); w.i32(s["entity"]); w.b8(s["is_3d"])
    w.i32(len(m["echo_zones"]))
    for z in m["echo_zones"]:
        w.i32(z["entity"]); w.f32(z["radius"]); w.f32(z["delay"])
    w.i32(len(m["chorus_zones"]))
    for z in m["chorus_zones"]:
        w.i32(z["entity"])
        w.fvec("<6f", (z["radius"], z["delay"], z["wet_dry_mix"], z["depth"],
                       z["feedback"], z["frequency"]))
        w.i32(z["phase"])


def _write_navigation(w: Writer, m: Dict[str, Any], version: int) -> None:
    w.u32(len(m["zones"]))
    for z in m["zones"]:
        w.i32(z["entity"]); w.vec3(z["extents"])
        if version > 0:
            w.u64(z["guid"]); w.u32(z["flags"])
        if version > 2:
            w.fvec("<6f", (z["cell_size"], z["cell_height"],
                           z["walkable_slope_angle"], z["agent_height"],
                           z["max_climb"], z["agent_radius"]))
    w.u32(len(m["agents"]))
    for a in m["agents"]:
        w.i32(a["entity"]); w.f32(a["radius"]); w.f32(a["height"])
        w.u32(a["flags"])


def _write_gui(w: Writer, m: Dict[str, Any], version: int) -> None:
    w.u32(len(m["rects"]))
    for rect in m["rects"]:
        w.u32(rect["flags"]); w.i32(rect["entity"])
        for side in ("top", "right", "bottom", "left"):
            w.f32(rect[side]["points"]); w.f32(rect[side]["relative"])
        img = rect.get("image")
        w.b8(img is not None)
        if img is not None:
            w.string(img["sprite"]); w.u32(img["color"]); w.u32(img["flags"])
        w.b8(rect["input_field"])
        txt = rect.get("text")
        w.b8(txt is not None)
        if txt is not None:
            w.string(txt["font"]); w.i32(txt["halign"]); w.i32(txt["valign"])
            w.u32(txt["color"]); w.i32(txt["font_size"]); w.string(txt["text"])
    w.u32(len(m["buttons"]))
    for b in m["buttons"]:
        w.i32(b["entity"]); w.u32(b["hovered_color"]); w.i32(b["hovered_cursor"])
    w.u32(len(m["canvases"]))
    for c in m["canvases"]:
        w.i32(c["entity"]); w.b8(c["is_3d"])
        if version > 0:
            w.b8(c["orient_to_camera"]); w.vec2(c["virtual_size"])


def _write_lua(w: Writer, m: Dict[str, Any], version: int) -> None:
    if version > 3:
        names = m.get("property_names", {})
        w.i32(len(names))
        for key, name in names.items():
            w.u64(key); w.string(name)
    if version > 1:
        w.i32(len(m["inline_scripts"]))
        for s in m["inline_scripts"]:
            w.i32(s["entity"]); w.string(s["source"])
    w.i32(len(m["scripts"]))
    for sc in m["scripts"]:
        w.i32(sc["entity"]); w.i32(len(sc["scripts"]))
        for s in sc["scripts"]:
            w.string(s["path"]); w.u32(s["flags"])
            w.i32(len(s["properties"]))
            for p in s["properties"]:
                if version <= 0:
                    w.u32(p["name_hash"])
                else:
                    w.u64(p["name_hash"])
                t = (p["type"] if isinstance(p["type"], int)
                     else _LUA_TYPES.index(p["type"]))
                w.i32(t)
                if version > 2:
                    is_array = p.get("is_array", False)
                    w.b8(is_array)
                    vals = p["value"] if is_array else [p["value"]]
                    if is_array:
                        w.u32(len(vals))
                    ptype = p["type"]
                    if ptype == "ENTITY":
                        for v in vals: w.i32(v)
                    elif ptype == "FLOAT":
                        for v in vals: w.f32(v)
                    elif ptype == "BOOLEAN":
                        for v in vals: w.b8(v)
                    elif ptype == "INT":
                        for v in vals: w.i32(v)
                    elif ptype == "COLOR":
                        for v in vals: w.vec3(v)
                    elif ptype in ("STRING", "RESOURCE"):
                        for v in vals: w.string(v)
                    else:
                        raise ValueError("unv write: lua ANY property")
                else:
                    w.string(p["value"])


def _write_core(w: Writer, m: Dict[str, Any], version: int) -> None:
    if version > 0:
        w.u32(len(m["signals"]))
        for s in m["signals"]:
            w.i32(s["entity"]); w.string(s["event_module"])
            w.string(s["event"]); w.string(s["function_module"])
            w.string(s["function"])
    w.u32(len(m["splines"]))
    for sp in m["splines"]:
        w.i32(sp["entity"])
        pts = np.asarray(sp["points"], dtype="<f4").reshape(-1, 3)
        w.i32(len(pts))
        w.raw(pts.tobytes())


def _write_renderer(w: Writer, m: Dict[str, Any], v: int) -> None:
    w.u32(len(m["cameras"]))
    for c in m["cameras"]:
        w.i32(c["entity"]); w.f32(c["fov"]); w.f32(c["near"]); w.f32(c["far"])
        w.f32(c["ortho_size"]); w.f32(c["screen_width"])
        w.f32(c["screen_height"]); w.b8(c["is_ortho"])
        if v > _RMV["POSTPROCESS"]:
            w.f32(c["film_grain_intensity"]); w.b8(c["dof_enabled"])
            w.f32(c["dof_distance"]); w.f32(c["dof_range"])
            w.f32(c["dof_max_blur_size"]); w.f32(c["dof_sharp_range"])
        else:
            w.raw(b"\0\0\0")

    if v <= _RMV["SMALLER_MODEL_INSTANCES"]:
        raise NotImplementedError("unv write: pre-SMALLER_MODEL_INSTANCES")

    # model instances: slot table indexed by entity id, with a shared
    # nul-separated path blob (≙ render_module.cpp serializeModelInstances)
    mis = {mi["entity"]: mi for mi in m["model_instances"]}
    paths: List[bytes] = []
    path_off: Dict[str, int] = {}
    off = 0
    for mi in m["model_instances"]:
        p = mi.get("model", "")
        if p and p not in path_off:
            path_off[p] = off
            enc = p.encode("utf-8") + b"\0"
            paths.append(enc)
            off += len(enc)
    blob = b"".join(paths)
    w.u32(len(blob))
    w.raw(blob)
    n_slots = (max(mis) + 1) if mis else 0
    w.u32(n_slots)
    for i in range(n_slots):
        mi = mis.get(i)
        if mi is None:
            w.u8(0)
            continue
        w.u8(mi["flags"])
        p = mi.get("model", "")
        w.u32(path_off[p] if p else 0xFFFFFFFF)
        ovr = mi.get("material_overrides", [])
        if v > _RMV["MATERIAL_OVERRIDE"]:
            w.u32(len(ovr))
            for o in ovr:
                w.string(o)
        else:
            w.string(ovr[0] if ovr else "")

    w.i32(len(m["point_lights"]))
    for pl in m["point_lights"]:
        w.vec3(pl["color"]); w.f32(pl["intensity"]); w.i32(pl["entity"])
        w.f32(pl["fov"]); w.f32(pl["attenuation"]); w.f32(pl["range"])
        w.u32(pl["flags"]); w.raw(b"\0\0\0\0"); w.u64(pl["guid"])

    w.i32(len(m["environments"]))
    for e in m["environments"]:
        w.vec3(e["light_color"]); w.f32(e["direct_intensity"])
        w.f32(e["indirect_intensity"]); w.i32(e["entity"])
        w.vec4(e["cascades"]); w.u32(e["flags"])
        if v > _RMV["POSTPROCESS"]:
            w.string(e["cubemap_sky"]); w.f32(e["sky_intensity"])
            w.vec3(e["scatter_rayleigh"]); w.vec3(e["scatter_mie"])
            w.vec3(e["absorb_mie"]); w.vec3(e["sunlight_color"])
            w.vec3(e["fog_scattering"]); w.f32(e["sunlight_strength"])
            w.f32(e["height_distribution_rayleigh"])
            w.f32(e["height_distribution_mie"])
            w.f32(e["ground_r"]); w.f32(e["atmo_r"]); w.f32(e["fog_top"])
            w.b8(e["atmo_enabled"])
            if v <= _RMV["FOG_DENSITY"]:
                w.b8(e["fog_density"] > 0.5)
            w.b8(e["godrays_enabled"])
            if v > _RMV["CLOUDS"]:
                w.b8(e["clouds_enabled"]); w.f32(e["clouds_top"])
                w.f32(e["clouds_bottom"])
            if v > _RMV["FOG_DENSITY"]:
                w.f32(e["fog_density"])
    w.i32(m.get("active_global_light", -1))

    w.i32(len(m["terrains"]))
    for t in m["terrains"]:
        w.i32(t["entity"]); w.u64(t["layer_mask"]); w.string(t["material"])
        w.f32(t["xz_scale"]); w.f32(t["y_scale"])
        if v > _RMV["TESSELATED_TERRAIN"]:
            w.u32(t["tesselation"]); w.u32(t["base_grid_res"])
        w.i32(len(t["grass"]))
        for g in t["grass"]:
            w.string(g["model"]); w.f32(g["spacing"]); w.f32(g["distance"])
            w.i32(g["rotation_mode"])

    w.u32(len(m["particle_emitters"]))
    for p in m["particle_emitters"]:
        w.i32(p["entity"])
        if v <= _RMV["EMIT_RATE_REMOVED"]:
            w.u32(p.get("emit_rate", 0))
        if v > _RMV["AUTODESTROY_EMITTER"]:
            w.b8(p.get("autodestroy", False))
        w.string(p["resource"])

    w.u32(len(m["bone_attachments"]))
    for ba in m["bone_attachments"]:
        if v <= _RMV["BONE_NAME_HASH"]:
            w.i32(ba["bone_index"])
        else:
            w.u64(ba["bone_name_hash"])
        w.i32(ba["entity"]); w.i32(ba["parent_entity"])
        w.local_rigid_transform(ba["relative_transform"])

    w.u32(len(m["environment_probes"]))
    for ep in m["environment_probes"]:
        w.i32(ep["entity"]); w.vec3(ep["inner_range"])
        w.vec3(ep["outer_range"]); w.u32(ep["flags"])
        w.raw(np.asarray(ep["sh_coefs"], dtype="<f4").reshape(9, 3).tobytes())

    w.u32(len(m["reflection_probes"]))
    for rp in m["reflection_probes"]:
        w.i32(rp["entity"]); w.u64(rp["guid"]); w.u32(rp["flags"])
        w.u32(rp["size"]); w.vec3(rp["half_extents"])

    w.u32(len(m["decals"]))
    for d in m["decals"]:
        w.i32(d["entity"]); w.vec3(d["half_extents"])
        if v > _RMV["DECAL_UV_SCALE"]:
            w.vec2(d["uv_scale"])
        w.string(d["material"])

    if v > _RMV["CURVE_DECALS"]:
        w.u32(len(m["curve_decals"]))
        for d in m["curve_decals"]:
            w.i32(d["entity"]); w.vec2(d["uv_scale"])
            w.f32(d["half_extent_y"]); w.vec2(d["bezier_p0"])
            w.vec2(d["bezier_p2"]); w.string(d["material"])

    if v <= _RMV["REMOVED_FUR"]:
        w.u32(0)

    if v > _RMV["INSTANCED_MODEL"]:
        w.u32(len(m["instanced_models"]))
        for im in m["instanced_models"]:
            w.i32(im["entity"]); w.string(im["model"])
            inst = np.asarray(im["instances"], dtype="<f4").reshape(-1, 8)
            w.u32(len(inst))
            w.raw(inst.tobytes())

    if _RMV["SPLINES"] < v <= _RMV["REMOVED_SPLINE_GEOMETRY"]:
        w.u32(0)

    if v > _RMV["SPLINES"]:
        w.u32(len(m["procedural_geometries"]))
        for pg in m["procedural_geometries"]:
            w.i32(pg["entity"]); w.string(pg["material"])
            w.u32(len(pg["vertex_data"])); w.raw(pg["vertex_data"])
            attrs = pg["attributes"]
            w.u32(len(attrs) // 4); w.raw(attrs)
            if v > _RMV["PROCEDURAL_GEOMETRY_PRIMITIVE_TYPE"]:
                w.u8(pg.get("primitive_type", 0))
            if v > _RMV["PROCEDURAL_GEOMETRY_INDEX_BUFFER"]:
                w.u32(len(pg["index_data"])); w.raw(pg["index_data"])
                w.u8(pg.get("index_type", 0))


_WRITERS = {"physics": _write_physics, "renderer": _write_renderer,
            "animation": _write_animation, "audio": _write_audio,
            "navigation": _write_navigation, "gui": _write_gui,
            "lua_script": _write_lua, "core": _write_core}


def write_unv(scene: Dict[str, Any]) -> bytes:
    """Serialize a neutral scene dict (the shape ``parse_unv`` returns) back
    to `.unv` bytes at the versions recorded in the dict."""
    version = scene.get("version", WV_LATEST)
    has_partitions = bool(scene.get("flags", 0) & 1)

    body = Writer()
    body.u32(len(scene["entities"]))  # reserve count
    for ent in scene["entities"]:
        body.i32(ent["entity"])
        body.dvec3(ent["pos"])
        body.quat(ent["rot"])
        body.vec3(ent["scale"])
        if has_partitions:
            body.parts.append(struct.pack("<H", ent.get("partition", 0)))
    body.i32(-1)

    body.u32(len(scene["names"]))
    for e, name in scene["names"].items():
        body.i32(e)
        body.string(name)

    body.u32(len(scene["hierarchy"]))
    for h in scene["hierarchy"]:
        body.i32(h["entity"]); body.i32(h["parent"])
        body.i32(h["first_child"]); body.i32(h["next_sibling"])
        body.dvec3(h["local_pos"]); body.quat(h["local_rot"])
        body.vec3(h["local_scale"])

    order = scene.get("_module_order") or [
        n for n in _WRITERS if n in scene]
    body.i32(len(order))
    for name in order:
        m = scene[name]
        body.string(name)
        body.i32(m["_version"])
        _WRITERS[name](body, m, m["_version"])

    if has_partitions:
        # Partition {u16 handle; char name[64]} + u16 active (world.cpp:884-888)
        parts = scene.get("partitions", [])
        body.u32(len(parts))
        for p in parts:
            body.parts.append(struct.pack("<H", p["handle"]))
            body.raw(p["name"].encode("utf-8")[:63].ljust(64, b"\0"))
        body.parts.append(struct.pack("<H", scene.get("active_partition", 0)))

    blob = body.getvalue()

    out = Writer()
    out.u32(MAGIC_LWRL)
    out.u32(version)
    out.i32(len(scene["modules"]))
    for name in scene["modules"]:
        out.string(name)
    out.u32(scene.get("flags", 0))
    if version > WV_COMPRESSED:
        from lumixengine_tpu_torch.utils import native
        comp = native.lz4_compress(blob)
        out.u32(len(blob))
        out.u32(len(comp))
        out.raw(comp)
    else:
        out.raw(blob)
    return out.getvalue()


def save_unv(scene: Dict[str, Any], path: str) -> None:
    with open(path, "wb") as f:
        f.write(write_unv(scene))
