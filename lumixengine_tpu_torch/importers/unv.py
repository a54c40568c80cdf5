"""Reference `.unv` world file importer (counterpart of
``lumixengine_tpu/importers/unv.py``).

Format (clean-room from LumixEngine src/engine/world.cpp:837-897 serialize,
:899-1043 deserialize): header {magic 'LWRL', version u32} + module-name list +
flags u32 + {uncompressed_size u32, compressed_size u32, LZ4 block} where the
blob is: entity list (id, DVec3 pos, Quat rot, Vec3 scale) terminated by -1,
names, hierarchy records, then per-module versioned blobs in module-list order.

Per-module formats are clean-room from each module's serialize/deserialize:
  physics    LumixEngine src/physics/physics_module.cpp:3553-3599
  renderer   LumixEngine src/renderer/render_module.cpp:962-1250
  animation  LumixEngine src/animation/animation_module.cpp:259-343
  audio      LumixEngine src/audio/audio_module.cpp (serialize/deserialize)
  navigation LumixEngine src/navigation/navigation_module.cpp
  gui        LumixEngine src/gui/gui_module.cpp
  lua_script LumixEngine src/lua/lua_script_system.cpp:1339-1510
  core       LumixEngine src/engine/core.cpp:33-120

The parser returns a neutral ``dict`` scene description; ``instantiate``
creates the entities/components in this engine's World.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List

import numpy as np

MAGIC_LWRL = 0x4C57524C  # 'LWRL' little-endian
MAGIC_LEGACY_EDITOR = struct.unpack("<I", b"VNUL")[0]

# WorldVersion (world.h:17-26)
WV_MERGED_HEADERS = 4
WV_COMPRESSED = 5
WV_LATEST = 6


class Reader:
    __slots__ = ("d", "o")

    def __init__(self, data: bytes, offset: int = 0):
        self.d = data
        self.o = offset

    def remaining(self) -> int:
        return len(self.d) - self.o

    def raw(self, n: int) -> bytes:
        b = self.d[self.o:self.o + n]
        if len(b) != n:
            raise EOFError(f"unv: wanted {n} bytes at {self.o}, have {len(b)}")
        self.o += n
        return b

    def _one(self, fmt: str):
        v = struct.unpack_from(fmt, self.d, self.o)[0]
        self.o += struct.calcsize(fmt)
        return v

    def u8(self): return self._one("<B")
    def b8(self): return bool(self._one("<B"))
    def i32(self): return self._one("<i")
    def u32(self): return self._one("<I")
    def u64(self): return self._one("<Q")
    def f32(self): return self._one("<f")
    def f64(self): return self._one("<d")

    def vec2(self): return struct.unpack_from("<2f", self.raw(8))
    def vec3(self): return struct.unpack_from("<3f", self.raw(12))
    def vec4(self): return struct.unpack_from("<4f", self.raw(16))
    def quat(self): return struct.unpack_from("<4f", self.raw(16))
    def dvec3(self): return struct.unpack_from("<3d", self.raw(24))

    def string(self) -> str:
        end = self.d.index(b"\0", self.o)
        s = self.d[self.o:end].decode("utf-8", "replace")
        self.o = end + 1
        return s

    def local_rigid_transform(self):
        # LocalRigidTransform {Vec3 pos; Quat rot} (math.h:262-270)
        return {"pos": self.vec3(), "rot": self.quat()}

    def rigid_transform(self):
        # RigidTransform {Quat rot; DVec3 pos} (math.h:272-283)
        rot = self.quat()
        pos = self.dvec3()
        return {"pos": pos, "rot": rot}

    def px_transform(self):
        # PxTransform {PxQuat q; PxVec3 p}
        rot = self.quat()
        pos = self.vec3()
        return {"pos": pos, "rot": rot}


# ---------------------------------------------------------------------------
# per-module parsers — each returns a dict of component-type -> list of records

def _parse_physics(r: Reader, version: int) -> Dict[str, Any]:
    # PhysicsModuleVersion: REMOVED_RAGDOLLS=0..CCD=6, LATEST=7
    out: Dict[str, Any] = {"actors": [], "controllers": [], "heightfields": [],
                           "instanced_cubes": [], "instanced_meshes": [],
                           "joints": [], "vehicles": [], "wheels": []}
    count = r.u32()
    for _ in range(count):  # deserializeActors (physics_module.cpp:3260)
        a: Dict[str, Any] = {"entity": r.i32()}
        a["dynamic_type"] = r.i32()          # 0 static 1 dynamic 2 kinematic
        a["is_trigger"] = r.b8()
        if version > 6:                       # > CCD
            a["ccd"] = r.b8()
        a["layer"] = r.u32()
        if version > 5:                       # > MATERIAL
            a["material"] = r.string()
        a["mesh"] = r.string()
        geoms = []
        for _ in range(r.i32()):
            g: Dict[str, Any] = {"type": r.i32(), "index": r.i32(),
                                 "local": r.rigid_transform()}
            if g["type"] == 0:                # PxGeometryType::eSPHERE
                g["radius"] = r.f32()
            elif g["type"] == 3:              # eBOX
                g["half_extents"] = r.vec3()
            elif g["type"] in (4, 5):         # convex/trimesh — no inline data
                pass
            else:
                raise ValueError(f"unv: unknown px geom type {g['type']}")
            geoms.append(g)
        a["geoms"] = geoms
        out["actors"].append(a)

    for _ in range(r.u32()):  # deserializeControllers (:3354)
        out["controllers"].append({
            "entity": r.i32(), "layer": r.u32(), "radius": r.f32(),
            "height": r.f32(), "custom_gravity": r.b8(),
            "custom_gravity_acceleration": r.f32(), "use_root_motion": r.b8(),
        })

    for _ in range(r.u32()):  # deserializeTerrains (:3532)
        out["heightfields"].append({
            "entity": r.i32(), "heightmap": r.string(),
            "xz_scale": r.f32(), "y_scale": r.f32(), "layer": r.u32(),
        })

    if version <= 0:  # <= REMOVED_RAGDOLLS
        assert r.u32() == 0

    if version > 3:  # > INSTANCED_CUBE
        for _ in range(r.i32()):
            out["instanced_cubes"].append({
                "entity": r.i32(), "half_extents": r.vec3(), "layer": r.u32()})
    if version > 4:  # > INSTANCED_MESH
        for _ in range(r.i32()):
            out["instanced_meshes"].append({
                "entity": r.i32(), "mesh": r.string(), "layer": r.u32()})

    # PxJointConcreteType: extensions start at PxConcreteType::eFIRST_PHYSX_EXTENSION=256
    _PXJ_SPHERICAL, _PXJ_REVOLUTE, _PXJ_PRISMATIC, _PXJ_FIXED, _PXJ_DISTANCE, _PXJ_D6 = \
        256, 257, 258, 259, 260, 261
    for _ in range(r.u32()):  # deserializeJoints (:3438)
        j: Dict[str, Any] = {"entity": r.i32(), "px_type": r.i32(),
                             "connected_body": r.i32()}
        j["local_frame0"] = r.px_transform()
        t = j["px_type"]
        if t == _PXJ_SPHERICAL:
            j["kind"] = "spherical"
            j["flags"] = r.u32()
            j["limit"] = struct.unpack_from("<7f", r.raw(28))  # PxJointLimitCone
        elif t == _PXJ_REVOLUTE:
            j["kind"] = "hinge"
            j["flags"] = r.u32()
            j["limit"] = struct.unpack_from("<7f", r.raw(28))  # AngularLimitPair
        elif t == _PXJ_DISTANCE:
            j["kind"] = "distance"
            j["flags"] = r.u32()
            (j["damping"], j["stiffness"], j["tolerance"],
             j["min_distance"], j["max_distance"]) = struct.unpack_from("<5f", r.raw(20))
        elif t == _PXJ_D6:
            j["kind"] = "d6"
            j["motions"] = struct.unpack_from("<6i", r.raw(24))
            j["linear_limit"] = struct.unpack_from("<6f", r.raw(24))
            j["swing_limit"] = struct.unpack_from("<7f", r.raw(28))
            j["twist_limit"] = struct.unpack_from("<7f", r.raw(28))
        else:
            raise ValueError(f"unv: unknown joint type {t}")
        out["joints"].append(j)

    for _ in range(r.u32()):  # deserializeVehicles (:3395)
        v: Dict[str, Any] = {"entity": r.i32(), "mass": r.f32(),
                             "center_of_mass": r.vec3(),
                             "moi_multiplier": r.f32(),
                             "chassis_layer": r.u32(), "wheels_layer": r.u32()}
        if version > 1:
            v["peak_torque"] = r.f32()
        if version > 2:
            v["max_rpm"] = r.f32()
        v["geom"] = r.string()
        out["vehicles"].append(v)
    for _ in range(r.u32()):
        w = {"entity": r.i32()}
        (w["mass"], w["radius"], w["width"], w["moi"], w["max_droop"],
         w["max_compression"], w["spring_strength"],
         w["spring_damper_rate"]) = struct.unpack_from("<8f", r.raw(32))
        w["slot"] = r.i32()
        out["wheels"].append(w)
    return out


# RenderModuleVersion (render_module.h:303-324)
_RMV = {name: i for i, name in enumerate([
    "DECAL_UV_SCALE", "CURVE_DECALS", "AUTODESTROY_EMITTER",
    "SMALLER_MODEL_INSTANCES", "INSTANCED_MODEL", "SPLINES",
    "SPLINES_VERTEX_COLORS", "PROCEDURAL_GEOMETRY_PRIMITIVE_TYPE",
    "PROCEDURAL_GEOMETRY_INDEX_BUFFER", "TESSELATED_TERRAIN",
    "REMOVED_SPLINE_GEOMETRY", "EMIT_RATE_REMOVED", "POSTPROCESS",
    "FOG_DENSITY", "CLOUDS", "MATERIAL_OVERRIDE", "REMOVED_FUR",
    "BONE_NAME_HASH"])}


def _parse_animation(r: Reader, version: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {"animables": [], "property_animators": [], "animators": []}
    for _ in range(r.u32()):
        out["animables"].append({"entity": r.i32(), "animation": r.string()})
    for _ in range(r.u32()):
        out["property_animators"].append({
            "entity": r.i32(), "animation": r.string(), "flags": r.u32()})
    for _ in range(r.u32()):
        a = {"default_set": r.u32(), "entity": r.i32()}
        if version > 0:  # > USE_ROOT_MOTION
            a["flags"] = r.u32()
        a["controller"] = r.string()
        out["animators"].append(a)
    return out


def _parse_audio(r: Reader, version: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {"listener": r.i32(), "ambient_sounds": [],
                           "echo_zones": [], "chorus_zones": []}
    if version < 1:  # < CLIPS_REWORKED
        assert r.i32() == 0
    for _ in range(r.i32()):
        out["ambient_sounds"].append({
            "clip": r.string(), "entity": r.i32(), "is_3d": r.b8()})
    for _ in range(r.i32()):
        out["echo_zones"].append({
            "entity": r.i32(), "radius": r.f32(), "delay": r.f32()})
    for _ in range(r.i32()):
        z = {"entity": r.i32()}
        (z["radius"], z["delay"], z["wet_dry_mix"], z["depth"],
         z["feedback"], z["frequency"]) = struct.unpack_from("<6f", r.raw(24))
        z["phase"] = r.i32()
        out["chorus_zones"].append(z)
    return out


def _parse_navigation(r: Reader, version: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {"zones": [], "agents": []}
    for _ in range(r.u32()):
        z: Dict[str, Any] = {"entity": r.i32(), "extents": r.vec3()}
        if version > 0:  # > ZONE_GUID
            z["guid"] = r.u64()
            z["flags"] = r.u32()
        if version > 2:  # > GENERATOR_PARAMS
            (z["cell_size"], z["cell_height"], z["walkable_slope_angle"],
             z["agent_height"], z["max_climb"],
             z["agent_radius"]) = struct.unpack_from("<6f", r.raw(24))
        out["zones"].append(z)
    for _ in range(r.u32()):
        out["agents"].append({"entity": r.i32(), "radius": r.f32(),
                              "height": r.f32(), "flags": r.u32()})
    return out


def _parse_gui(r: Reader, version: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {"rects": [], "buttons": [], "canvases": []}
    for _ in range(r.u32()):
        rect: Dict[str, Any] = {"flags": r.u32(), "entity": r.i32()}
        for side in ("top", "right", "bottom", "left"):
            rect[side] = {"points": r.f32(), "relative": r.f32()}
        if r.b8():
            rect["image"] = {"sprite": r.string(), "color": r.u32(),
                             "flags": r.u32()}
        rect["input_field"] = r.b8()
        if r.b8():
            rect["text"] = {"font": r.string(), "halign": r.i32(),
                            "valign": r.i32(), "color": r.u32(),
                            "font_size": r.i32(), "text": r.string()}
        out["rects"].append(rect)
    for _ in range(r.u32()):
        out["buttons"].append({"entity": r.i32(), "hovered_color": r.u32(),
                               "hovered_cursor": r.i32()})
    for _ in range(r.u32()):
        c = {"entity": r.i32(), "is_3d": r.b8()}
        if version > 0:  # > CANVAS_3D
            c["orient_to_camera"] = r.b8()
            c["virtual_size"] = r.vec2()
        out["canvases"].append(c)
    return out


_LUA_TYPES = ["BOOLEAN", "FLOAT", "INT", "ENTITY", "RESOURCE", "STRING", "COLOR", "ANY"]


def _parse_lua(r: Reader, version: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {"property_names": {}, "inline_scripts": [], "scripts": []}
    if version > 3:  # > STRING_NAMES
        for _ in range(r.i32()):
            key = r.u64()
            out["property_names"][key] = r.string()
    if version > 1:  # > INLINE_SCRIPT
        for _ in range(r.i32()):
            out["inline_scripts"].append({"entity": r.i32(), "source": r.string()})
    for _ in range(r.i32()):
        sc: Dict[str, Any] = {"entity": r.i32(), "scripts": []}
        for _ in range(r.i32()):
            s: Dict[str, Any] = {"path": r.string(), "flags": r.u32(),
                                 "properties": []}
            for _ in range(r.i32()):
                p: Dict[str, Any] = {}
                if version <= 0:  # <= HASH64
                    p["name_hash"] = r.u32()
                else:
                    p["name_hash"] = r.u64()
                p["name"] = out["property_names"].get(p["name_hash"], "")
                t = r.i32()
                p["type"] = _LUA_TYPES[t] if 0 <= t < len(_LUA_TYPES) else t
                if version > 2:  # > ARRAY_PROPERTIES
                    is_array = r.b8()
                    n = r.u32() if is_array else 1
                    p["is_array"] = is_array
                    if p["type"] == "ENTITY":
                        p["value"] = [r.i32() for _ in range(n)]
                    elif p["type"] == "FLOAT":
                        p["value"] = [r.f32() for _ in range(n)]
                    elif p["type"] == "BOOLEAN":
                        p["value"] = [r.b8() for _ in range(n)]
                    elif p["type"] == "INT":
                        p["value"] = [r.i32() for _ in range(n)]
                    elif p["type"] == "COLOR":
                        p["value"] = [r.vec3() for _ in range(n)]
                    elif p["type"] in ("STRING", "RESOURCE"):
                        p["value"] = [r.string() for _ in range(n)]
                    else:
                        raise ValueError(f"unv: lua ANY property")
                    if not is_array:
                        p["value"] = p["value"][0]
                else:
                    p["value"] = r.string()
                s["properties"].append(p)
            sc["scripts"].append(s)
        out["scripts"].append(sc)
    return out


def _parse_core(r: Reader, version: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {"signals": [], "splines": []}
    if version > 0:  # > SIGNALS
        for _ in range(r.u32()):
            out["signals"].append({
                "entity": r.i32(), "event_module": r.string(),
                "event": r.string(), "function_module": r.string(),
                "function": r.string()})
    for _ in range(r.u32()):
        e = r.i32()
        n = r.i32()
        pts = np.frombuffer(r.raw(12 * n), dtype="<f4").reshape(n, 3).copy()
        out["splines"].append({"entity": e, "points": pts})
    return out


def parse_unv(data: bytes) -> Dict[str, Any]:
    """Parse a `.unv` world file into a neutral scene dict."""
    r = Reader(data)
    magic = r.u32()
    version = r.u32()
    if magic != MAGIC_LWRL:
        raise ValueError(f"unv: bad magic {magic:#x} (legacy editor headers unsupported)")
    if version > WV_LATEST:
        raise ValueError(f"unv: unsupported world version {version}")
    module_names = [r.string() for _ in range(r.i32())]
    flags = r.u32()
    has_partitions = bool(flags & 1)

    if version > WV_COMPRESSED:
        usize = r.u32()
        csize = r.u32()
        comp = r.raw(csize)
        from lumixengine_tpu_torch.utils import native

        blob = native.lz4_decompress(comp, usize)
        r = Reader(blob)

    scene: Dict[str, Any] = {"version": version, "modules": module_names,
                             "flags": flags, "entities": [], "names": {},
                             "hierarchy": [], "_module_order": []}
    r.u32()  # reserve count
    while True:
        e = r.i32()
        if e == -1:
            break
        ent = {"entity": e, "pos": r.dvec3(), "rot": r.quat(), "scale": r.vec3()}
        if has_partitions:
            ent["partition"] = struct.unpack("<H", r.raw(2))[0]
        scene["entities"].append(ent)

    for _ in range(r.u32()):
        e = r.i32()
        scene["names"][e] = r.string()

    for _ in range(r.u32()):
        # Hierarchy::local_transform is a full Transform {DVec3 pos; Quat rot;
        # Vec3 scale} (world.h:157-164) — pos is double precision.
        h = {"entity": r.i32(), "parent": r.i32(), "first_child": r.i32(),
             "next_sibling": r.i32()}
        h["local_pos"] = r.dvec3()
        h["local_rot"] = r.quat()
        h["local_scale"] = r.vec3()
        scene["hierarchy"].append(h)

    parsers = {"physics": _parse_physics, "renderer": _parse_renderer_full,
               "animation": _parse_animation, "audio": _parse_audio,
               "navigation": _parse_navigation, "gui": _parse_gui,
               "lua_script": _parse_lua, "core": _parse_core}
    nm = r.i32()
    for _ in range(nm):
        name = r.string()
        mver = r.i32()
        fn = parsers.get(name)
        if fn is None:
            raise ValueError(f"unv: no parser for module '{name}'")
        scene[name] = fn(r, mver)
        scene[name]["_version"] = mver
        scene["_module_order"].append(name)

    if has_partitions:
        # Partition {u16 handle; char name[64]} memcpy'd (world.h:56-59,
        # world.cpp:884-888) + u16 active partition. No shipped map carries
        # records (count 0), but additive-saved worlds do.
        parts = []
        for _ in range(r.u32()):
            handle = struct.unpack("<H", r.raw(2))[0]
            name = r.raw(64).split(b"\0", 1)[0].decode("utf-8", "replace")
            parts.append({"handle": handle, "name": name})
        scene["partitions"] = parts
        scene["active_partition"] = struct.unpack("<H", r.raw(2))[0]
    if r.remaining() != 0:
        raise ValueError(f"unv: {r.remaining()} trailing bytes — format drift")
    return scene


def _parse_renderer_full(r: Reader, v: int) -> Dict[str, Any]:
    """Full renderer module parse (replaces the stub raising in _parse_renderer)."""
    out: Dict[str, Any] = {k: [] for k in (
        "cameras", "model_instances", "point_lights", "environments",
        "terrains", "particle_emitters", "bone_attachments",
        "environment_probes", "reflection_probes", "decals", "curve_decals",
        "instanced_models", "procedural_geometries")}

    for _ in range(r.u32()):
        c = {"entity": r.i32(), "fov": r.f32(), "near": r.f32(),
             "far": r.f32(), "ortho_size": r.f32(), "screen_width": r.f32(),
             "screen_height": r.f32(), "is_ortho": r.b8()}
        if v > _RMV["POSTPROCESS"]:
            c["film_grain_intensity"] = r.f32()
            c["dof_enabled"] = r.b8()
            c["dof_distance"] = r.f32()
            c["dof_range"] = r.f32()
            c["dof_max_blur_size"] = r.f32()
            c["dof_sharp_range"] = r.f32()
        else:
            r.raw(3)
        out["cameras"].append(c)

    if v <= _RMV["SMALLER_MODEL_INSTANCES"]:
        raise NotImplementedError("unv: pre-SMALLER_MODEL_INSTANCES worlds")
    paths_blob = r.raw(r.u32())

    def path_at(off: int) -> str:
        end = paths_blob.index(b"\0", off)
        return paths_blob[off:end].decode("utf-8", "replace")

    n = r.u32()
    for i in range(n):
        flags = r.u8()
        if not (flags & 4):  # ModelInstance::VALID = 1<<2 (render_module.h:211)
            continue
        mi: Dict[str, Any] = {"entity": i, "flags": flags, "model": ""}
        off = r.u32()
        if off != 0xFFFFFFFF:
            mi["model"] = path_at(off)
        if v > _RMV["MATERIAL_OVERRIDE"]:
            mi["material_overrides"] = [r.string() for _ in range(r.u32())]
        else:
            mo = r.string()
            mi["material_overrides"] = [mo] if mo else []
        out["model_instances"].append(mi)

    for _ in range(r.i32()):  # point lights, memcpy'd struct (48 B w/ pad)
        pl = {"color": r.vec3(), "intensity": r.f32(), "entity": r.i32(),
              "fov": r.f32(), "attenuation": r.f32(), "range": r.f32(),
              "flags": r.u32()}
        r.raw(4)
        pl["guid"] = r.u64()
        out["point_lights"].append(pl)

    for _ in range(r.i32()):  # environments
        e = {"light_color": r.vec3(), "direct_intensity": r.f32(),
             "indirect_intensity": r.f32(), "entity": r.i32(),
             "cascades": r.vec4(), "flags": r.u32()}
        if v > _RMV["POSTPROCESS"]:
            e["cubemap_sky"] = r.string()
            e["sky_intensity"] = r.f32()
            e["scatter_rayleigh"] = r.vec3()
            e["scatter_mie"] = r.vec3()
            e["absorb_mie"] = r.vec3()
            e["sunlight_color"] = r.vec3()
            e["fog_scattering"] = r.vec3()
            e["sunlight_strength"] = r.f32()
            e["height_distribution_rayleigh"] = r.f32()
            e["height_distribution_mie"] = r.f32()
            e["ground_r"] = r.f32()
            e["atmo_r"] = r.f32()
            e["fog_top"] = r.f32()
            e["atmo_enabled"] = r.b8()
            if v <= _RMV["FOG_DENSITY"]:
                e["fog_density"] = 1.0 if r.b8() else 0.0
            e["godrays_enabled"] = r.b8()
            if v > _RMV["CLOUDS"]:
                e["clouds_enabled"] = r.b8()
                e["clouds_top"] = r.f32()
                e["clouds_bottom"] = r.f32()
            if v > _RMV["FOG_DENSITY"]:
                e["fog_density"] = r.f32()
        out["environments"].append(e)
    out["active_global_light"] = r.i32()

    for _ in range(r.i32()):  # terrains (terrain.cpp:323)
        t: Dict[str, Any] = {"entity": r.i32()}
        t["layer_mask"] = r.u64()
        t["material"] = r.string()
        t["xz_scale"] = r.f32()
        t["y_scale"] = r.f32()
        if v > _RMV["TESSELATED_TERRAIN"]:
            t["tesselation"] = r.u32()
            t["base_grid_res"] = r.u32()
        grass = []
        for _ in range(r.i32()):
            grass.append({"model": r.string(), "spacing": r.f32(),
                          "distance": r.f32(), "rotation_mode": r.i32()})
        t["grass"] = grass
        out["terrains"].append(t)

    for _ in range(r.u32()):  # particle systems (particle_system.cpp:455-475)
        p: Dict[str, Any] = {"entity": r.i32()}
        if v <= _RMV["EMIT_RATE_REMOVED"]:
            p["emit_rate"] = r.u32()
        if v > _RMV["AUTODESTROY_EMITTER"]:
            p["autodestroy"] = r.b8()
        p["resource"] = r.string()
        out["particle_emitters"].append(p)

    for _ in range(r.u32()):  # bone attachments
        ba: Dict[str, Any] = {}
        if v <= _RMV["BONE_NAME_HASH"]:
            ba["bone_index"] = r.i32()
        else:
            ba["bone_name_hash"] = r.u64()
        ba["entity"] = r.i32()
        ba["parent_entity"] = r.i32()
        ba["relative_transform"] = r.local_rigid_transform()
        out["bone_attachments"].append(ba)

    for _ in range(r.u32()):  # environment probes (memcpy, 136 B)
        ep = {"entity": r.i32(), "inner_range": r.vec3(),
              "outer_range": r.vec3(), "flags": r.u32()}
        ep["sh_coefs"] = np.frombuffer(r.raw(108), dtype="<f4").reshape(9, 3).copy()
        out["environment_probes"].append(ep)

    for _ in range(r.u32()):  # reflection probes
        out["reflection_probes"].append({
            "entity": r.i32(), "guid": r.u64(), "flags": r.u32(),
            "size": r.u32(), "half_extents": r.vec3()})

    for _ in range(r.u32()):  # decals
        d: Dict[str, Any] = {"entity": r.i32(), "half_extents": r.vec3()}
        if v > _RMV["DECAL_UV_SCALE"]:
            d["uv_scale"] = r.vec2()
        d["material"] = r.string()
        out["decals"].append(d)

    if v > _RMV["CURVE_DECALS"]:
        for _ in range(r.u32()):
            out["curve_decals"].append({
                "entity": r.i32(), "uv_scale": r.vec2(),
                "half_extent_y": r.f32(), "bezier_p0": r.vec2(),
                "bezier_p2": r.vec2(), "material": r.string()})

    if v <= _RMV["REMOVED_FUR"]:
        assert r.u32() == 0, "unv: fur components unsupported"

    if v > _RMV["INSTANCED_MODEL"]:
        for _ in range(r.u32()):
            im: Dict[str, Any] = {"entity": r.i32(), "model": r.string()}
            cnt = r.u32()
            raw = np.frombuffer(r.raw(32 * cnt), dtype="<f4").reshape(cnt, 8).copy()
            # InstanceData {Vec3 rot_quat; float lod; Vec3 pos; float scale}
            im["instances"] = raw
            out["instanced_models"].append(im)

    if _RMV["SPLINES"] < v <= _RMV["REMOVED_SPLINE_GEOMETRY"]:
        assert r.u32() == 0, "unv: spline geometry unsupported"

    if v > _RMV["SPLINES"]:  # procedural geometries
        for _ in range(r.u32()):
            pg: Dict[str, Any] = {"entity": r.i32(), "material": r.string()}
            pg["vertex_data"] = r.raw(r.u32())
            nattr = r.u32()
            pg["attributes"] = r.raw(nattr * 4)  # gpu::Attribute is 4 B packed
            if v > _RMV["PROCEDURAL_GEOMETRY_PRIMITIVE_TYPE"]:
                pg["primitive_type"] = r.u8()
            if v > _RMV["PROCEDURAL_GEOMETRY_INDEX_BUFFER"]:
                pg["index_data"] = r.raw(r.u32())
                pg["index_type"] = r.u8()
            out["procedural_geometries"].append(pg)
    return out


def load_unv(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return parse_unv(f.read())
