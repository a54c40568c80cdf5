"""The `.unv` world file, `.nav` zones, `.act` controllers and `.anp` property
animations in the port (importers/) against the JAX package, on inputs the
test builds: ``write_unv`` gives equal bytes in both packages on four scenes
that together hold every record of every module section (the latest
versions, older module versions with partitions, the load-and-save phase's
stress scene at test size, and a scene without a compressed body), and
``parse_unv`` of either package's bytes gives equal dicts; ``parse_nav``
(the NAVM layout and the legacy headerless one) and ``rasterize_walkable``
equal; ``parse_act``/``write_act`` and ``parse_anp``/``to_component_curves``
equal. All comparisons are exact."""
import struct

import numpy as np
import pytest

from lumixengine_tpu.importers import act as ract
from lumixengine_tpu.importers import anp as ranp
from lumixengine_tpu.importers import navmesh as rnav
from lumixengine_tpu.importers import unv as runv
from lumixengine_tpu.importers import unv_write as rwrite
from lumixengine_tpu_torch.importers import act as pact
from lumixengine_tpu_torch.importers import anp as panp
from lumixengine_tpu_torch.importers import navmesh as pnav
from lumixengine_tpu_torch.importers import unv as punv
from lumixengine_tpu_torch.importers import unv_write as pwrite
from lumixengine_tpu_torch.models import host_scenes as H


def deep_eq(a, b):
    """Equal scene dicts (host_scenes.scene_diff names the first difference)."""
    diff = H.scene_diff(a, b)
    assert diff is None, diff


def full_scene():
    """Every record type of every module at the latest versions."""
    rng = np.random.default_rng(3)
    sc = H.empty_scene()
    ents = [H.add_entity(sc, rng.uniform(-5, 5, 3), name=f"e{i}") for i in range(24)]
    H.link_hierarchy(sc, {3: 2, 4: 2, 5: 4}, {3: (1.0, 0.0, 0.0), 4: (0.0, 1.0, 0.0),
                                              5: (0.0, 0.0, 1.0)})
    local = {"pos": (0.1, 0.2, 0.3), "rot": (0.0, 0.0, 0.0, 1.0)}
    p = sc["physics"]
    H.actor(sc, ents[0], 1, "box", (0.5, 0.25, 0.75), layer=2)
    H.actor(sc, ents[1], 0, "sphere", 0.4)
    p["actors"].append({"entity": ents[2], "dynamic_type": 2, "is_trigger": True, "ccd": True,
                        "layer": 1, "material": "mat/ice.pma", "mesh": "models/rock.fbx",
                        "geoms": [{"type": 4, "index": 0, "local": local},
                                  {"type": 5, "index": 1, "local": local}]})
    p["controllers"].append({"entity": ents[3], "layer": 0, "radius": 0.4, "height": 1.8,
                             "custom_gravity": True, "custom_gravity_acceleration": 7.5,
                             "use_root_motion": False})
    p["heightfields"].append({"entity": ents[4], "heightmap": "terrain/h.raw", "xz_scale": 0.5,
                              "y_scale": 20.0, "layer": 0})
    p["instanced_cubes"].append({"entity": ents[5], "half_extents": (0.5, 0.5, 0.5), "layer": 3})
    p["instanced_meshes"].append({"entity": ents[6], "mesh": "models/tree.fbx", "layer": 1})
    lim7 = tuple(float(x) for x in rng.uniform(0, 1, 7))
    for t, extra in ((256, {"kind": "spherical", "flags": 1, "limit": lim7}),
                     (257, {"kind": "hinge", "flags": 3, "limit": lim7}),
                     (260, {"kind": "distance", "flags": 2, "damping": 0.1, "stiffness": 5.0,
                            "tolerance": 0.01, "min_distance": 0.5, "max_distance": 2.0}),
                     (261, {"kind": "d6", "motions": (0, 1, 2, 2, 1, 0),
                            "linear_limit": tuple(float(x) for x in rng.uniform(0, 1, 6)),
                            "swing_limit": lim7, "twist_limit": lim7})):
        p["joints"].append({"entity": ents[0], "px_type": t, "connected_body": ents[1],
                            "local_frame0": local, **extra})
    p["vehicles"].append({"entity": ents[7], "mass": 1500.0, "center_of_mass": (0.0, 0.2, 0.1),
                          "moi_multiplier": 1.2, "chassis_layer": 1, "wheels_layer": 2,
                          "peak_torque": 450.0, "max_rpm": 5500.0, "geom": "models/car.fbx"})
    p["wheels"].append({"entity": ents[8], "mass": 20.0, "radius": 0.35, "width": 0.2,
                        "moi": 1.1, "max_droop": 0.1, "max_compression": 0.12,
                        "spring_strength": 30000.0, "spring_damper_rate": 4000.0, "slot": 2})
    r = sc["renderer"]
    H.camera(sc, ents[9], fov=1.1)
    for e, m in ((ents[10], "models/a.fbx"), (ents[12], "models/b.fbx"), (ents[13], "models/a.fbx")):
        H.model_instance(sc, e, m)
    r["model_instances"][1]["material_overrides"] = ["mat/x.mat", "mat/y.mat"]
    H.point_light(sc, ents[11], (1.0, 0.5, 0.25), 3.0, 12.0, guid=9)
    r["environments"].append({
        "light_color": (1.0, 0.9, 0.8), "direct_intensity": 2.0, "indirect_intensity": 0.5,
        "entity": ents[14], "cascades": (3.0, 8.0, 20.0, 60.0), "flags": 1,
        "cubemap_sky": "sky/day.ltc", "sky_intensity": 1.0, "scatter_rayleigh": (5.8, 13.5, 33.1),
        "scatter_mie": (2.0, 2.0, 2.0), "absorb_mie": (0.1, 0.1, 0.1),
        "sunlight_color": (1.0, 1.0, 0.9), "fog_scattering": (0.1, 0.1, 0.1),
        "sunlight_strength": 10.0, "height_distribution_rayleigh": 8.0,
        "height_distribution_mie": 1.2, "ground_r": 6378.0, "atmo_r": 6478.0, "fog_top": 100.0,
        "atmo_enabled": True, "godrays_enabled": False, "clouds_enabled": True,
        "clouds_top": 2000.0, "clouds_bottom": 1500.0, "fog_density": 0.25})
    r["active_global_light"] = ents[14]
    r["terrains"].append({"entity": ents[15], "layer_mask": 0xFF00FF, "material": "t/t.mat",
                          "xz_scale": 1.0, "y_scale": 30.0, "tesselation": 4,
                          "base_grid_res": 64, "grass": [
                              {"model": "g/grass.fbx", "spacing": 0.5, "distance": 40.0,
                               "rotation_mode": 1}]})
    r["particle_emitters"].append({"entity": ents[16], "autodestroy": True,
                                   "resource": "particles/fire.par"})
    r["bone_attachments"].append({"bone_name_hash": 0x1234ABCD5678, "entity": ents[17],
                                  "parent_entity": ents[10],
                                  "relative_transform": {"pos": (0.0, 0.1, 0.0),
                                                         "rot": (0.0, 0.0, 0.0, 1.0)}})
    r["environment_probes"].append({"entity": ents[18], "inner_range": (5.0, 5.0, 5.0),
                                    "outer_range": (9.0, 9.0, 9.0), "flags": 1,
                                    "sh_coefs": rng.uniform(0, 1, (9, 3)).astype(np.float32)})
    r["reflection_probes"].append({"entity": ents[19], "guid": 77, "flags": 1, "size": 256,
                                   "half_extents": (10.0, 5.0, 10.0)})
    r["decals"].append({"entity": ents[20], "half_extents": (1.0, 0.5, 1.0),
                        "uv_scale": (2.0, 2.0), "material": "d/dirt.mat"})
    r["curve_decals"].append({"entity": ents[21], "uv_scale": (1.0, 3.0), "half_extent_y": 0.4,
                              "bezier_p0": (0.0, 0.0), "bezier_p2": (4.0, 1.0),
                              "material": "d/road.mat"})
    r["instanced_models"].append({"entity": ents[22], "model": "models/rock.fbx",
                                  "instances": rng.uniform(-1, 1, (5, 8)).astype(np.float32)})
    r["procedural_geometries"].append({"entity": ents[23], "material": "p/p.mat",
                                       "vertex_data": bytes(range(48)),
                                       "attributes": bytes([1, 2, 3, 4, 5, 6, 7, 8]),
                                       "primitive_type": 1, "index_data": bytes(12),
                                       "index_type": 0})
    a = sc["animation"]
    a["animables"].append({"entity": ents[10], "animation": ".ani:models/a.fbx"})
    a["property_animators"].append({"entity": ents[11], "animation": "anims/light.anp",
                                    "flags": 1})
    a["animators"].append({"default_set": 0, "entity": ents[12], "flags": 1,
                           "controller": "anims/hero.act"})
    au = sc["audio"]
    au["listener"] = ents[9]
    au["ambient_sounds"].append({"clip": "s/wind.ogg", "entity": ents[13], "is_3d": True})
    au["echo_zones"].append({"entity": ents[14], "radius": 10.0, "delay": 0.3})
    au["chorus_zones"].append({"entity": ents[15], "radius": 8.0, "delay": 0.02,
                               "wet_dry_mix": 0.5, "depth": 0.2, "feedback": 0.1,
                               "frequency": 1.1, "phase": 90})
    nav = sc["navigation"]
    nav["zones"].append({"entity": ents[16], "extents": (20.0, 2.0, 20.0), "guid": 123456789,
                         "flags": 1, "cell_size": 0.3, "cell_height": 0.1,
                         "walkable_slope_angle": 60.0, "agent_height": 1.8, "max_climb": 0.3,
                         "agent_radius": 0.3})
    nav["agents"].append({"entity": ents[17], "radius": 0.4, "height": 1.8, "flags": 0})
    H.gui_rect(sc, ents[18], (0.1, 0.1, 0.4, 0.2), text="hello")
    sc["gui"]["rects"][0]["input_field"] = True
    H.gui_rect(sc, ents[19], (0.5, 0.1, 0.9, 0.2))
    del sc["gui"]["rects"][1]["image"]
    sc["gui"]["buttons"].append({"entity": ents[18], "hovered_color": 0xFF00FF00,
                                 "hovered_cursor": 2})
    sc["gui"]["canvases"].append({"entity": ents[20], "is_3d": True, "orient_to_camera": False,
                                  "virtual_size": (800.0, 600.0)})
    lua = sc["lua_script"]
    lua["property_names"] = {101: "speed", 102: "target", 103: "tint"}
    lua["inline_scripts"].append({"entity": ents[21], "source": "function update(dt) end"})
    props = [
        {"name_hash": 101, "name": "speed", "type": "FLOAT", "is_array": False, "value": 2.5},
        {"name_hash": 102, "name": "target", "type": "ENTITY", "is_array": True,
         "value": [ents[1], ents[2]]},
        {"name_hash": 103, "name": "tint", "type": "COLOR", "is_array": False,
         "value": (1.0, 0.0, 0.5)},
        {"name_hash": 104, "name": "", "type": "BOOLEAN", "is_array": False, "value": True},
        {"name_hash": 105, "name": "", "type": "INT", "is_array": True, "value": [1, 2, 3]},
        {"name_hash": 106, "name": "", "type": "STRING", "is_array": False, "value": "hi"},
        {"name_hash": 107, "name": "", "type": "RESOURCE", "is_array": False,
         "value": "sounds/x.ogg"}]
    lua["scripts"].append({"entity": ents[22], "scripts": [
        {"path": "scripts/a.lua", "flags": 1, "properties": props},
        {"path": "scripts/b.lua", "flags": 0, "properties": []}]})
    sc["core"]["signals"].append({"entity": ents[18], "event_module": "gui",
                                  "event": "buttonClicked", "function_module": "lua_script",
                                  "function": "call"})
    sc["core"]["splines"].append({"entity": ents[23], "points": rng.uniform(
        -3, 3, (5, 3)).astype(np.float32)})
    return sc


def older_scene():
    """The full scene at older module versions, with named partitions and
    per-entity partition tags, in a different module order."""
    sc = full_scene()
    sc["flags"] = 1
    for i, ent in enumerate(sc["entities"]):
        ent["partition"] = i % 3
    sc["partitions"] = [{"handle": 0, "name": "main"}, {"handle": 1, "name": "level"},
                        {"handle": 2, "name": "streamed"}]
    sc["active_partition"] = 1
    versions = {"physics": 3, "renderer": 12, "animation": 0, "audio": 0, "navigation": 0,
                "gui": 0, "lua_script": 3, "core": 0}
    for name, v in versions.items():
        sc[name]["_version"] = v
    sc["_module_order"] = ["core", "lua_script", "renderer", "physics", "animation", "audio",
                           "navigation", "gui"]
    # fields those versions do not carry: dropped so that a parse equals the dict
    r = sc["renderer"]
    for c in r["cameras"]:
        for k in ("film_grain_intensity", "dof_enabled", "dof_distance", "dof_range",
                  "dof_max_blur_size", "dof_sharp_range"):
            c.pop(k)
    r["environments"] = [{k: e[k] for k in ("light_color", "direct_intensity",
                                            "indirect_intensity", "entity", "cascades",
                                            "flags")} for e in r["environments"]]
    for mi in r["model_instances"]:
        mi["material_overrides"] = mi["material_overrides"][:1]
    for p in r["particle_emitters"]:
        p["emit_rate"] = 30
    for b in r["bone_attachments"]:
        del b["bone_name_hash"]
        b["bone_index"] = 3
    for v in sc["physics"]["vehicles"]:
        v.pop("max_rpm")
    sc["physics"]["instanced_meshes"] = []
    for a in sc["physics"]["actors"]:
        a.pop("ccd")
        a.pop("material")
    for a in sc["animation"]["animators"]:
        a.pop("flags")
    for z in sc["navigation"]["zones"]:
        for k in ("guid", "flags", "cell_size", "cell_height", "walkable_slope_angle",
                  "agent_height", "max_climb", "agent_radius"):
            z.pop(k)
    for c in sc["gui"]["canvases"]:
        c.pop("orient_to_camera")
        c.pop("virtual_size")
    sc["core"]["signals"] = []
    return sc


def uncompressed_scene():
    """World version 4 (no compressed body), a few entities and a camera."""
    sc = H.empty_scene(("renderer", "core"))
    sc["version"] = 4
    cam = H.add_entity(sc, (0.0, 1.0, 5.0), name="cam")
    H.camera(sc, cam)
    H.add_entity(sc, (1.0, 0.0, 0.0))
    return sc


SCENES = {"full": full_scene, "older": older_scene,
          "stress": lambda: H.stress_scene(entities=400, bodies=16, agents=8),
          "uncompressed": uncompressed_scene}


@pytest.mark.parametrize("name", list(SCENES))
def test_write_unv_bytes_equal_the_reference(name):
    scene = SCENES[name]()
    got, ref = pwrite.write_unv(scene), rwrite.write_unv(scene)
    assert got == ref
    parsed = punv.parse_unv(got)
    deep_eq(parsed, runv.parse_unv(got))
    deep_eq(runv.parse_unv(got), punv.parse_unv(ref))
    # the dict the test wrote comes back (the fields each version carries)
    again = pwrite.write_unv(parsed)
    assert again == got
    assert parsed["_module_order"] == scene["_module_order"]


def test_every_module_section_and_record_is_covered():
    """The scenes above hold at least one record of every list the parser
    fills, and each module at two versions."""
    seen, versions = set(), {}
    for name in ("full", "older", "stress"):
        sc = punv.parse_unv(pwrite.write_unv(SCENES[name]()))
        for mname in sc["_module_order"]:
            versions.setdefault(mname, set()).add(sc[mname]["_version"])
            for key, val in sc[mname].items():
                if isinstance(val, list) and val:
                    seen.add((mname, key))
    want = {(m, k) for m, keys in {
        "physics": ("actors", "controllers", "heightfields", "instanced_cubes",
                    "instanced_meshes", "joints", "vehicles", "wheels"),
        "renderer": ("cameras", "model_instances", "point_lights", "environments", "terrains",
                     "particle_emitters", "bone_attachments", "environment_probes",
                     "reflection_probes", "decals", "curve_decals", "instanced_models",
                     "procedural_geometries"),
        "animation": ("animables", "property_animators", "animators"),
        "audio": ("ambient_sounds", "echo_zones", "chorus_zones"),
        "navigation": ("zones", "agents"), "gui": ("rects", "buttons", "canvases"),
        "lua_script": ("inline_scripts", "scripts"), "core": ("signals", "splines")}.items()
        for k in keys}
    assert want <= seen, want - seen
    assert all(len(v) == 2 for v in versions.values()), versions


def test_bad_magic_and_trailing_bytes_raise():
    good = pwrite.write_unv(uncompressed_scene())
    for parse in (punv.parse_unv, runv.parse_unv):
        with pytest.raises(ValueError):
            parse(b"XXXX" + good[4:])
        with pytest.raises(ValueError, match="trailing"):
            parse(good + b"\0")


def test_load_and_save_unv_files(tmp_path):
    scene = SCENES["stress"]()
    path = str(tmp_path / "w.unv")
    pwrite.save_unv(scene, path)
    deep_eq(punv.load_unv(path), runv.load_unv(path))
    assert open(path, "rb").read() == rwrite.write_unv(scene)


# -- .nav zones ----------------------------------------------------------------------


def _legacy_nav(polys, origin):
    """The headerless legacy layout: tiles_x, tiles_z, params, then each
    tile as i32 size and raw bytes."""
    tile = H.detour_tile(polys)
    return (struct.pack("<II", 1, 1) + struct.pack("<5f2i", *origin, 64.0, 64.0, 1, len(polys))
            + struct.pack("<i", len(tile)) + tile)


@pytest.mark.parametrize("layout", ["navm", "legacy"])
def test_parse_nav_and_rasterize_walkable_equal_the_reference(layout):
    polys = H.ring_zone_polys(20.0, 4.0, y=0.5)
    # a triangle and a hexagon, and an off-mesh connection the parser skips
    polys.append(np.array([[25, 0, 25], [25, 0, 30], [30, 0, 25]], np.float32))
    polys.append(np.array([[-30 + 3 * np.cos(a), 0, 30 + 3 * np.sin(a)]
                           for a in np.linspace(0, 2 * np.pi, 7)[:-1]], np.float32))
    blob = (H.nav_blob(polys, origin=(-32.0, 0.0, -32.0)) if layout == "navm"
            else _legacy_nav(polys, (-32.0, 0.0, -32.0)))
    got, ref = pnav.parse_nav(blob), rnav.parse_nav(blob)
    assert got.origin == ref.origin and got.tile_size == ref.tile_size
    assert len(got.polys) == len(ref.polys) == len(polys)
    for a, b in zip(got.polys, ref.polys):
        np.testing.assert_array_equal(a.verts, b.verts)
        assert (a.area, a.flags) == (b.area, b.flags)
    assert got.bounds_xz == ref.bounds_xz
    for origin, size, cell in (((-32.0, -32.0), (64.0, 64.0), 0.6), ((-10.0, -12.0), (25, 31), 0.5)):
        g = pnav.rasterize_walkable(got, origin, size, cell)
        np.testing.assert_array_equal(g, rnav.rasterize_walkable(ref, origin, size, cell))
        assert 0 < g.mean() < 1
    tile = bytearray(H.detour_tile(polys))
    tile[100 + 12 * sum(len(p) for p in polys) + 31] |= 0x40    # first poly: off-mesh
    assert len(pnav.parse_tile(bytes(tile))) == len(rnav.parse_tile(bytes(tile))) == len(polys) - 1


def test_load_nav_zone_searches_the_dirs(tmp_path):
    path = H.write_stress_nav(str(tmp_path / "data"))
    dirs = (str(tmp_path / "none"), str(tmp_path / "data"))
    got = pnav.load_nav_zone(H.STRESS_NAV_GUID, dirs)
    ref = rnav.load_nav_zone(H.STRESS_NAV_GUID, dirs)
    assert path.endswith(f"navzones/{H.STRESS_NAV_GUID}.nav")
    assert len(got.polys) == len(ref.polys) == 4
    assert pnav.load_nav_zone(1, dirs) is None


# -- .act and .anp -------------------------------------------------------------------

ANP_TEXT = """
{ type = "Position X", keyframes = [0, 15, 30], values = [0.0, 2.5, -1.0] }
{ version = 1, type = "Scale Y", keyframes = [0.0, 0.5, 1.25], values = [1, 2e0, 0.5] }
{ type = "Rotation", keyframes = [0, 10], values = [0, 1] }
{ version = 1, type = "Local position Z", keyframes = [0.0, 1.0], values = [-3, 3] }
"""


def _act_bytes():
    inputs = [(0, b"speed_x"), (0, b"speed_y"), (3, b"stance"), (2, b"aim")]
    slots = [b"idle", b"walk forward", b"walk left", b"run forward", b"crouching idle",
             b"crouching walk forward", b"jump"]
    out = b"CAL_" + struct.pack("<II", 6, 42) + b"models/hero.fbx\0"
    out += struct.pack("<I", len(inputs))
    for t, name in inputs:
        out += struct.pack("<I", t) + name.ljust(31, b"\0") + b"\x7f"   # garbage after the \0
    out += struct.pack("<I", len(slots)) + b"".join(s + b"\0" for s in slots)
    entries = [(i, 0, f".ani:anims/{i}.fbx".encode()) for i in range(len(slots))]
    entries.append((1, 1, b"anims/alt.fbx"))
    out += struct.pack("<I", len(entries))
    for slot, set_, path in entries:
        out += struct.pack("<II", slot, set_) + path + b"\0"
    return out + b"\x01\x02opaque graph\x00"


def test_act_and_anp_parsers_equal_the_reference():
    blob = _act_bytes()
    got, ref = pact.parse_act(blob), ract.parse_act(blob)
    deep_eq(got, ref)
    assert pact.write_act(got) == ract.write_act(ref) == blob
    edited = dict(got, slots=got["slots"][:-1] + ["leap"])
    assert pact.write_act(edited) == ract.write_act(edited)
    assert [pact._slot_point(s) for s in got["slots"]] == [ract._slot_point(s)
                                                           for s in ref["slots"]]
    curves = panp.parse_anp(ANP_TEXT)
    deep_eq(curves, ranp.parse_anp(ANP_TEXT))
    deep_eq(panp.to_component_curves(curves), ranp.to_component_curves(curves))
    assert len(panp.to_component_curves(curves)) == 3
    with pytest.raises(ValueError):
        pact.parse_act(b"XXXX" + blob[4:])
