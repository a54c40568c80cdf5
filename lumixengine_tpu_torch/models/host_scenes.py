"""Scene dicts and navmesh blobs for the host tier (``importers/``): the
neutral scene description ``importers.unv.parse_unv`` returns and
``importers.unv_write.write_unv`` writes, built in code (the repository
ships no assets), and ``.nav`` zone files packed with ``struct`` to the
layout ``importers.navmesh.parse_nav`` reads.

``stress_scene`` is sized like the reference's stress maps (about 180 KB of
``.unv`` each): 2,048 entities in a three-level hierarchy, most of them
model instances of placeholder models; dynamic boxes and spheres over a
static slab; point lights and a camera; animables; a nav zone whose guid
names a packed ``.nav``, with agents; GUI rects, one a button wired by a
core signal into its Lua script; ambient sounds; inline Lua scripts, one of
which spawns a model instance with ``createEntityEx`` when it starts.
Every value comes from ``seed`` and is a float32 value, and each child's
global position is its parent's plus its local one in float32, so that a
world instantiated from the scene exports (``instantiate.export_scene``)
back to the same dict. The dicts hold only Python and numpy values, so both
packages instantiate the same dict.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Sequence

import numpy as np

WORLD_VERSION = 6          # WV_LATEST: an LZ4-compressed body
# each module's latest version (the parsers' and writers' branches)
MODULE_VERSIONS = {"physics": 7, "renderer": 18, "animation": 1, "audio": 1, "navigation": 3,
                   "gui": 1, "lua_script": 4, "core": 1}
IDENTITY = (0.0, 0.0, 0.0, 1.0)


def f32(x) -> float:
    """`x` rounded to float32, as a Python float (what a World stores)."""
    return float(np.float32(x))


def f32v(v) -> tuple:
    return tuple(f32(x) for x in v)


def empty_scene(modules: Sequence[str] = tuple(MODULE_VERSIONS)) -> Dict[str, Any]:
    """A scene with no entities and an empty section of each module."""
    sections = {
        "physics": {k: [] for k in ("actors", "controllers", "heightfields", "instanced_cubes",
                                     "instanced_meshes", "joints", "vehicles", "wheels")},
        "renderer": {**{k: [] for k in (
            "cameras", "model_instances", "point_lights", "environments", "terrains",
            "particle_emitters", "bone_attachments", "environment_probes",
            "reflection_probes", "decals", "curve_decals", "instanced_models",
            "procedural_geometries")}, "active_global_light": -1},
        "animation": {"animables": [], "property_animators": [], "animators": []},
        "audio": {"listener": -1, "ambient_sounds": [], "echo_zones": [], "chorus_zones": []},
        "navigation": {"zones": [], "agents": []},
        "gui": {"rects": [], "buttons": [], "canvases": []},
        "lua_script": {"property_names": {}, "inline_scripts": [], "scripts": []},
        "core": {"signals": [], "splines": []},
    }
    scene: Dict[str, Any] = {"version": WORLD_VERSION, "modules": list(modules), "flags": 0,
                             "entities": [], "names": {}, "hierarchy": [],
                             "_module_order": list(modules)}
    for name in modules:
        scene[name] = {**sections[name], "_version": MODULE_VERSIONS[name]}
    return scene


def add_entity(scene, pos, rot=IDENTITY, scale=(1.0, 1.0, 1.0), name=None) -> int:
    """A new entity record (global pose); returns its source id."""
    e = len(scene["entities"])
    scene["entities"].append({"entity": e, "pos": f32v(pos), "rot": f32v(rot),
                              "scale": f32v(scale)})
    if name is not None:
        scene["names"][e] = name
    return e


def link_hierarchy(scene, parent_of: Dict[int, int], local_pos: Dict[int, tuple]) -> None:
    """Hierarchy records (with the reference's first_child/next_sibling
    links) for each child → parent of `parent_of`, identity local rotation
    and unit scale."""
    children: Dict[int, List[int]] = {}
    for c in sorted(parent_of):
        children.setdefault(parent_of[c], []).append(c)
    for s in sorted(set(parent_of) | set(children)):
        sibs = children.get(parent_of.get(s, -1), [])
        i = sibs.index(s) if s in sibs else -1
        scene["hierarchy"].append({
            "entity": s, "parent": parent_of.get(s, -1),
            "first_child": children.get(s, [-1])[0],
            "next_sibling": sibs[i + 1] if 0 <= i < len(sibs) - 1 else -1,
            "local_pos": f32v(local_pos.get(s, scene["entities"][s]["pos"])),
            "local_rot": IDENTITY, "local_scale": (1.0, 1.0, 1.0)})


def model_instance(scene, e: int, model: str) -> None:
    scene["renderer"]["model_instances"].append({"entity": e, "flags": 6, "model": model,
                                                 "material_overrides": []})


def actor(scene, e: int, motion: int, shape: str, size, layer: int = 0) -> None:
    """A rigid actor of one geom: motion 0 static, 1 dynamic, 2 kinematic;
    shape "box" (half extents) or "sphere" (radius)."""
    local = {"pos": (0.0, 0.0, 0.0), "rot": IDENTITY}
    geom = ({"type": 3, "index": 0, "local": local, "half_extents": f32v(size)}
            if shape == "box" else {"type": 0, "index": 0, "local": local, "radius": f32(size)})
    scene["physics"]["actors"].append({"entity": e, "dynamic_type": motion, "is_trigger": False,
                                       "ccd": False, "layer": layer, "material": "", "mesh": "",
                                       "geoms": [geom]})


def camera(scene, e: int, fov: float = 1.0, near: float = 0.1, far: float = 500.0) -> None:
    scene["renderer"]["cameras"].append({
        "entity": e, "fov": f32(fov), "near": f32(near), "far": f32(far), "ortho_size": 10.0,
        "screen_width": 1920.0, "screen_height": 1080.0, "is_ortho": False,
        "film_grain_intensity": 0.0, "dof_enabled": False, "dof_distance": 10.0,
        "dof_range": 5.0, "dof_max_blur_size": 10.0, "dof_sharp_range": 1.0})


def point_light(scene, e: int, color, intensity: float, rng: float, guid: int) -> None:
    scene["renderer"]["point_lights"].append({
        "color": f32v(color), "intensity": f32(intensity), "entity": e,
        "fov": f32(6.2831855), "attenuation": 1.0, "range": f32(rng), "flags": 0, "guid": guid})


def gui_rect(scene, e: int, box, color: int = 0xFF336699, text: str = "") -> None:
    """A rect anchored at the canvas fractions `box` (left, top, right,
    bottom), with an image and, when `text` is given, a text."""
    left, top, right, bottom = box
    rect = {"flags": 1, "entity": e,
            "top": {"points": 0.0, "relative": f32(top)},
            "right": {"points": 0.0, "relative": f32(right)},
            "bottom": {"points": 0.0, "relative": f32(bottom)},
            "left": {"points": 0.0, "relative": f32(left)},
            "image": {"sprite": "", "color": color, "flags": 0}, "input_field": False}
    if text:
        rect["text"] = {"font": "", "halign": 0, "valign": 0, "color": 0xFFFFFFFF,
                        "font_size": 20, "text": text}
    scene["gui"]["rects"].append(rect)


# -- .nav zone files ----------------------------------------------------------------

NAV_MAGIC = 0x4E41564D
DT_MAGIC = 0x444E4156


def detour_tile(polys: Sequence[np.ndarray]) -> bytes:
    """A Detour tile (dtMeshHeader, 4-byte-aligned verts and polys) of
    convex polygons [n, 3] (n <= 6), walkable area 63, flags 1."""
    verts = np.concatenate([np.asarray(p, np.float32) for p in polys], 0)
    header = struct.pack("<15i10f", DT_MAGIC, 7, 0, 0, 0, 0, len(polys), len(verts),
                         0, 0, 0, 0, 0, 0, 0, *([0.0] * 10))
    out = header + verts.astype("<f4").tobytes()
    first = 0
    for p in polys:
        n = len(p)
        idx = list(range(first, first + n)) + [0] * (6 - n)
        out += struct.pack("<I6H6HHBB", 0, *idx, *([0] * 6), 1, n, 63)
        first += n
    return out


def nav_blob(polys: Sequence[np.ndarray], origin=(0.0, 0.0, 0.0), tile=(64.0, 64.0)) -> bytes:
    """A `.nav` zone file: the 'NAVM' header, one tile of `polys`, its
    Detour data as one LZ4 block (the shared csrc/lz4_codec.cpp)."""
    from lumixengine_tpu_torch.utils import native

    tile_data = detour_tile(polys)
    comp = native.lz4_compress(tile_data)
    return (struct.pack("<IIII", NAV_MAGIC, 1, 1, 1)
            + struct.pack("<5f2i", *origin, *tile, 1, len(polys))
            + struct.pack("<iI", len(tile_data), len(comp)) + comp)


def ring_zone_polys(half: float, hole: float, y: float = 0.0) -> List[np.ndarray]:
    """Four quads covering [-half, half]² around a square hole of half-width
    `hole` at the centre (an obstacle the agents walk around)."""
    q = []
    for x0, z0, x1, z1 in ((-half, -half, half, -hole), (-half, hole, half, half),
                           (-half, -hole, -hole, hole), (hole, -hole, half, hole)):
        q.append(np.array([[x0, y, z0], [x0, y, z1], [x1, y, z1], [x1, y, z0]], np.float32))
    return q


# -- the stress scene ------------------------------------------------------------------

SPAWN_LUA = """
local t = 0
function start()
    this.world:createEntityEx({
        position = {0, 6, -4},
        model_instance = { source = "models/spawned.fbx" }
    })
end
function update(dt)
    t = t + dt
end
"""

ORBIT_LUA = """
local pos = {}
local t = 0

function start()
    pos = this.position
end

function update(time_delta)
    t = t + time_delta
    this.position = {
        pos[1] + math.cos(t) * 2,
        pos[2],
        pos[3] + math.sin(t) * 2
    }
end
"""

BUTTON_LUA = """
clicks = 0
function onSignal()
    clicks = clicks + 1
end
"""

STRESS_NAV_GUID = 4051913317


def stress_scene(seed: int = 0, entities: int = 2048, bodies: int = 64, lights: int = 8,
                 animables: int = 16, agents: int = 32, rects: int = 4, sounds: int = 2,
                 scripts: int = 8, nav_guid: int = STRESS_NAV_GUID) -> Dict[str, Any]:
    """The load-and-save phase's world, described above. The scene holds
    `entities` entities: the camera, the slab, the bodies, the lights, the
    nav zone, the agents, the rects, the sounds and the script holders, the
    rest groups of one root, 7 children and 49 grandchildren of placeholder
    models (the animables among them); `nav_guid` names the zone's `.nav`."""
    rng = np.random.default_rng(seed)
    sc = empty_scene()
    cam = add_entity(sc, (0.0, 18.0, 70.0), name="camera")
    camera(sc, cam)
    sc["audio"]["listener"] = cam
    slab = add_entity(sc, (0.0, 0.5, 0.0), name="slab")
    actor(sc, slab, 0, "box", (24.0, 0.5, 24.0))
    model_instance(sc, slab, "models/slab.fbx")
    side = int(np.ceil(np.sqrt(bodies)))
    for i in range(bodies):
        x, z = (i % side - side / 2 + 0.5) * 2.5, (i // side - side / 2 + 0.5) * 2.5
        e = add_entity(sc, (x, 1.6 + float(rng.uniform(0.05, 1.2)), z), name=f"body{i}")
        if i % 2:
            actor(sc, e, 1, "sphere", 0.5)
            model_instance(sc, e, "models/sphere.fbx")
        else:
            actor(sc, e, 1, "box", tuple(float(h) for h in rng.uniform(0.3, 0.6, 3)))
            model_instance(sc, e, "models/cube.fbx")
    for i in range(lights):
        a = 2 * np.pi * i / lights
        e = add_entity(sc, (30 * np.cos(a), 6.0, 30 * np.sin(a)), name=f"light{i}")
        point_light(sc, e, rng.uniform(0.3, 1.0, 3), rng.uniform(1.0, 4.0), 25.0, guid=i + 1)
    zone = add_entity(sc, (0.0, 0.0, 0.0), name="nav_zone")
    sc["navigation"]["zones"].append({
        "entity": zone, "extents": (32.0, 2.0, 32.0), "guid": int(nav_guid), "flags": 0,
        "cell_size": 0.3, "cell_height": 0.1, "walkable_slope_angle": 60.0,
        "agent_height": 1.8, "max_climb": 0.3, "agent_radius": 0.3})
    for i in range(agents):
        a = 2 * np.pi * i / agents
        e = add_entity(sc, (26 * np.cos(a), 0.0, 26 * np.sin(a)), name=f"agent{i}")
        sc["navigation"]["agents"].append({"entity": e, "radius": 0.4, "height": 1.8,
                                           "flags": 0})
    for i in range(rects):
        e = add_entity(sc, (0.0, 0.0, 0.0), name=f"rect{i}")
        x0 = 0.05 + 0.24 * i
        gui_rect(sc, e, (x0, 0.85, x0 + 0.2, 0.95), text=f"slot {i}")
        if i == 0:
            sc["gui"]["buttons"].append({"entity": e, "hovered_color": 0xFF88AACC,
                                         "hovered_cursor": 0})
            sc["lua_script"]["inline_scripts"].append({"entity": e, "source": BUTTON_LUA})
            sc["core"]["signals"].append({"entity": e, "event_module": "gui",
                                          "event": "buttonClicked",
                                          "function_module": "lua_script", "function": "call"})
    for i in range(sounds):
        e = add_entity(sc, (10.0 * i - 5.0, 1.0, 0.0), name=f"sound{i}")
        sc["audio"]["ambient_sounds"].append({"clip": f"sounds/ambient{i}.ogg", "entity": e,
                                              "is_3d": bool(i)})
    for i in range(scripts - 1):
        e = add_entity(sc, (-20.0 + 6.0 * i, 3.0, -20.0), name=f"orbiter{i}")
        model_instance(sc, e, "models/crate.fbx")
        sc["lua_script"]["inline_scripts"].append({"entity": e, "source": ORBIT_LUA})
    spawner = add_entity(sc, (0.0, 0.0, -30.0), name="spawner")
    sc["lua_script"]["inline_scripts"].append({"entity": spawner, "source": SPAWN_LUA})
    spline = add_entity(sc, (0.0, 0.0, 0.0), name="spline")
    sc["core"]["splines"].append({"entity": spline, "points": np.array(
        [[-10, 0, -10], [0, 1, -5], [10, 0, -10], [15, 2, 0]], np.float32)})
    # the hierarchy: groups of a root, 7 children, 49 grandchildren
    parent_of: Dict[int, int] = {}
    local: Dict[int, tuple] = {}
    models = ("models/tree.fbx", "models/rock.fbx", "models/crate.fbx", "models/lamp.fbx")
    n_anim = 0
    g = 0
    while len(sc["entities"]) < entities:
        gx, gz = (g % 8 - 3.5) * 12.0, (g // 8 - 3.5) * 12.0
        root = add_entity(sc, (gx, 0.0, gz), name=f"group{g}")
        model_instance(sc, root, models[g % len(models)])
        for c in range(7):
            if len(sc["entities"]) >= entities:
                break
            lp = np.float32([np.cos(c) * 3.0, 0.5, np.sin(c) * 3.0])
            cpos = np.float32([gx, 0.0, gz]) + lp
            child = add_entity(sc, cpos)
            parent_of[child], local[child] = root, lp
            if n_anim < animables and c == 0:
                model_instance(sc, child, "models/hero.fbx")
                sc["animation"]["animables"].append({"entity": child,
                                                     "animation": ".ani:models/hero.fbx"})
                n_anim += 1
            else:
                model_instance(sc, child, models[(g + c) % len(models)])
            for k in range(7):
                if len(sc["entities"]) >= entities:
                    break
                lq = np.float32([np.cos(k) * 0.8, 0.3 + 0.1 * k, np.sin(k) * 0.8])
                gc = add_entity(sc, cpos + lq)
                parent_of[gc], local[gc] = child, lq
                model_instance(sc, gc, models[(g + c + k) % len(models)])
        g += 1
    link_hierarchy(sc, parent_of, local)
    return sc


def scene_diff(a, b, path: str = "scene"):
    """The first path at which two scene dicts differ (numpy arrays by
    dtype and value, NaN equal to NaN), or None."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return path
        for k in a:
            d = scene_diff(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return path
        for i, (x, y) in enumerate(zip(a, b)):
            d = scene_diff(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        return None if x.dtype == y.dtype and x.shape == y.shape and (x == y).all() else path
    return None if (a == b or (a != a and b != b)) else path


def write_stress_nav(data_dir: str, nav_guid: int = STRESS_NAV_GUID) -> str:
    """The stress scene's zone file, navzones/<guid>.nav under `data_dir`:
    the zone's 64 m square with a 6 m square hole at its centre."""
    import os

    path = os.path.join(data_dir, "navzones", f"{nav_guid}.nav")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(nav_blob(ring_zone_polys(32.0, 3.0), origin=(-32.0, 0.0, -32.0)))
    return path
