"""Instantiate a parsed `.unv` scene dict (importers/unv.py) into an Engine +
World (counterpart of ``lumixengine_tpu/importers/instantiate.py``) — the
analog of the reference's World::deserialize + per-module deserialize
(world.cpp:899, each module's deserialize) driven by the Runner's loadWorld
(app/main.cpp:118). The engine it builds runs its step on `device` (the card
unless the caller passes a CPU device).

Asset references (.fbx models, .ani clips, .act controllers, .pat particle
scripts, heightmaps) resolve through ``SceneAssets`` against ``data_dirs``,
which the caller passes (default: the engine's base path): an FBX file that
is found is parsed (``importers/fbx.py``) into the model, with its ``.meta``
sidecar applied (``importers/model_meta.py``), or into the clip of its take;
a file that is not found, or does not parse, becomes a placeholder resource,
counted in the report, as in the reference. The placeholder skeletons and
clips are seeded with ``abs(hash(path))`` as in the reference; Python salts
``str`` hashes per process, so the two packages' placeholders agree only
within one process.

Entity ids are remapped via an EntityMap like the reference's additive load
(world.h:35-44): scene entity id -> our World entity id.
"""
from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from lumixengine_tpu_torch.core import host_math as hm


def _u32_color(c: int) -> Tuple[float, float, float, float]:
    """ABGR u32 (imgui convention used by the reference) -> rgba floats."""
    return ((c & 0xFF) / 255.0, ((c >> 8) & 0xFF) / 255.0,
            ((c >> 16) & 0xFF) / 255.0, ((c >> 24) & 0xFF) / 255.0)


class SceneAssets:
    """Resolves the scene's asset paths against real importers + search dirs;
    falls back to procedural placeholders (reported)."""

    def __init__(self, renderer, anim=None, audio_system=None,
                 data_dirs: Tuple[str, ...] = (), report: Optional[Counter] = None):
        self.renderer = renderer
        self.anim = anim
        self.audio_system = audio_system
        self.data_dirs = tuple(data_dirs)
        self.report = report if report is not None else Counter()
        self._model_ids: Dict[str, int] = {}
        self._clip_ids: Dict[str, int] = {}
        self._ctrl_ids: Dict[str, int] = {}
        self._audio_ids: Dict[str, int] = {}
        self._skinned_paths: set = set()
        self._fbx_cache: Dict[str, Any] = {}

    def find_file(self, path: str) -> Optional[str]:
        # "engine/" is a mount onto the engine data dir (≙ FileSystem mounts)
        cands = [path]
        if path.startswith("engine/"):
            cands.append(path[len("engine/"):])
        for d in self.data_dirs:
            for c in cands:
                p = os.path.join(d, c)
                if os.path.isfile(p):
                    return p
        return None

    def mark_skinned(self, path: str) -> None:
        self._skinned_paths.add(path)

    # -- models ---------------------------------------------------------------

    def _load_fbx(self, path: str):
        """Parsed FBX document cache (None if unavailable/unparseable)."""
        if path in self._fbx_cache:
            return self._fbx_cache[path]
        doc = None
        real = self.find_file(path)
        if real is not None:
            try:
                from lumixengine_tpu_torch.importers import fbx

                doc = fbx.load_fbx(real)
            except Exception:
                doc = None
        self._fbx_cache[path] = doc
        return doc

    def model_id(self, path: str) -> int:
        if path in self._model_ids:
            return self._model_ids[path]
        from lumixengine_tpu_torch.renderer.model import Model, make_humanoid_skeleton

        model = None
        doc = self._load_fbx(path)
        if doc is not None:
            try:
                from lumixengine_tpu_torch.importers import fbx
                from lumixengine_tpu_torch.importers import model_meta as MM

                model = fbx.to_model(doc, name=path)
                # the .meta sidecar: import scale, origin, culling scale, LODs
                real = self.find_file(path)
                if real is not None:
                    MM.apply_meta(model, MM.load_meta_for(real))
                self.report["model_fbx"] += 1
            except Exception:
                model = None
        if model is None:
            skeleton = None
            if path in self._skinned_paths:
                skeleton = make_humanoid_skeleton(32, seed=abs(hash(path)) % 2**31)
            base = os.path.basename(path).lower()
            radius = {"cube.fbx": 0.87, "plane.fbx": 100.0, "sphere.fbx": 0.5}.get(base, 1.2)
            model = Model(name=path, bounding_radius=radius, skeleton=skeleton)
            self.report["model_placeholder"] += 1
        self._model_ids[path] = self.renderer.add_model(model)
        return self._model_ids[path]

    def model_skeleton(self, path: str):
        mid = self.model_id(path)
        return self.renderer.models.get(mid).skeleton

    # -- animation clips -------------------------------------------------------

    def clip_id(self, anim_path: str, model_path: str) -> int:
        """Resolve `.ani:models/x.fbx`-style animation refs (FBX-embedded
        takes) or bare paths into the clip bank."""
        key = anim_path
        if key in self._clip_ids:
            return self._clip_ids[key]
        sk = self.model_skeleton(model_path)
        if sk is None:
            from lumixengine_tpu_torch.renderer.model import make_humanoid_skeleton

            sk = make_humanoid_skeleton(32, seed=3)
        fbx_path = anim_path.split(":", 1)[1] if ":" in anim_path else anim_path
        clip = None
        doc = self._load_fbx(fbx_path)
        if doc is not None:
            try:
                from lumixengine_tpu_torch.importers import fbx

                clip = fbx.to_clip(doc, sk, name=anim_path)
                self.report["clip_fbx"] += 1
            except Exception:
                clip = None
        if clip is None:
            from lumixengine_tpu_torch.animation.animation import make_walk_clip

            clip = make_walk_clip(sk, anim_path, frames=25, fps=30.0,
                                  amplitude=0.3, seed=abs(hash(anim_path)) % 2**31)
            self.report["clip_placeholder"] += 1
        self._clip_ids[key] = self.anim.add_clip(clip)
        return self._clip_ids[key]

    # -- controllers (.act) ----------------------------------------------------

    def controller_id(self, path: str, model_path: str) -> int:
        if path in self._ctrl_ids:
            return self._ctrl_ids[path]
        cid = None
        real = self.find_file(path)
        if real is not None:
            try:
                from lumixengine_tpu_torch.importers import act

                cid = act.load_controller(real, self, model_path)
                self.report["controller_act"] += 1
            except Exception:
                cid = None
        if cid is None:
            from lumixengine_tpu_torch.animation.controller import AnimationNode, Controller

            clip0 = self.clip_id(f".ani:{model_path}", model_path)
            ctrl = Controller(path, self.anim.bank_statics, AnimationNode(clip0))
            cid = self.anim.add_controller(ctrl)
            self.report["controller_placeholder"] += 1
        self._ctrl_ids[path] = cid
        return cid

    # -- particle scripts -------------------------------------------------------

    def particle_script(self, path: str) -> Optional[str]:
        """Register the .pat source under its path name; None if unusable.
        Emitters may reference the COMPILED `.par` — resolve to the sibling
        `.pat` source like the AssetCompiler's source↔product mapping."""
        if path in self.renderer.particle_scripts:
            return path
        real = self.find_file(path)
        if real is None and path.endswith(".par"):
            real = self.find_file(path[:-4] + ".pat")
        elif real is not None and real.endswith(".par"):
            src_side = self.find_file(path[:-4] + ".pat")
            real = src_side or None
        if real is None:
            self.report["particle_missing"] += 1
            return None
        try:
            with open(real, "r", errors="replace") as f:
                src = f.read()
            imports = {}
            dirs = [os.path.dirname(real)]
            dirs += [os.path.join(d, "particles") for d in self.data_dirs]
            for base in dirs:
                if not os.path.isdir(base):
                    continue
                for fn in os.listdir(base):
                    if fn.endswith((".pih", ".pai")):
                        with open(os.path.join(base, fn), "r", errors="replace") as g:
                            imports.setdefault(fn, g.read())
            self.renderer.add_particle_script(path, src, imports=imports)
            # compile now so failures are counted here, not at component create
            self.renderer.particle_system(path)
            self.report["particle_ok"] += 1
            return path
        except Exception:
            self.renderer.particle_scripts.pop(path, None)
            self.report["particle_failed"] += 1
            return None

    # -- audio clips -------------------------------------------------------------

    def audio_clip_id(self, path: str) -> int:
        if path in self._audio_ids:
            return self._audio_ids[path]
        from lumixengine_tpu_torch.audio.module import AudioClip

        rate = 44100
        data = np.zeros(rate // 10, np.float32)  # placeholder (wav importer later)
        self.report["audio_placeholder"] += 1
        self._audio_ids[path] = self.audio_system.add_clip(
            AudioClip(name=path, samples=data, rate=rate))
        return self._audio_ids[path]


@dataclass
class InstantiatedScene:
    engine: Any
    world: Any
    emap: Dict[int, int]
    report: Counter
    assets: SceneAssets
    skipped: List[str] = field(default_factory=list)
    scene: Optional[Dict[str, Any]] = None  # retained parsed .unv (save path)


def build_engine_for_scene(scene: Dict[str, Any], data_dirs: Optional[Tuple[str, ...]] = None,
                           device="cuda", base_path: str = "."):
    """Create an Engine with every system the scene's module list needs,
    capacities sized from the scene (≙ createAllStatic + project systems),
    stepping on `device`; assets resolve against `data_dirs` (default: the
    engine's base path)."""
    from lumixengine_tpu_torch.animation.module import AnimationSystem
    from lumixengine_tpu_torch.audio.module import AudioSystem
    from lumixengine_tpu_torch.engine.core_module import CoreSystem
    from lumixengine_tpu_torch.engine.engine import Engine
    from lumixengine_tpu_torch.gui.module import GuiSystem
    from lumixengine_tpu_torch.navigation.module import NavigationSystem
    from lumixengine_tpu_torch.physics.module import PhysicsSystem
    from lumixengine_tpu_torch.renderer.render_module import RendererSystem
    from lumixengine_tpu_torch.script.module import ScriptSystem

    import torch

    engine = Engine(base_path=base_path)
    engine.device = torch.device(device)
    if data_dirs is None:
        data_dirs = (base_path,)
    r = scene.get("renderer", {})
    a = scene.get("animation", {})
    p = scene.get("physics", {})
    n_ents = max(len(scene["entities"]), 1)
    # running Lua content can SPAWN entities/components (createEntityEx —
    # tetris pieces, nav-stress ybots); give script-bearing scenes headroom
    lua_s = scene.get("lua_script", {})
    has_scripts = bool(lua_s.get("scripts") or lua_s.get("inline_scripts"))
    hr = 384 if has_scripts else 0
    engine.module_capacities = {
        "model_instances": max(len(r.get("model_instances", [])) + 8, 16) + hr,
        "cameras": max(len(r.get("cameras", [])) + 1, 4),
        "point_lights": max(len(r.get("point_lights", [])) + 4, 8),
        "actors": max(len(p.get("actors", [])) + 4, 8),
        "joints": max(len(p.get("joints", [])) + 4, 8),
        "animables": max(len(a.get("animables", [])) + 4, 8),
        "animators": max(len(a.get("animators", [])) + 4, 8) + hr // 4,
        "nav_agents": max(len(scene.get("navigation", {}).get("agents", [])) + 4, 8) + hr // 4,
        "gui_rects": max(len(scene.get("gui", {}).get("rects", [])) + 4, 8),
        "sounds": max(len(scene.get("audio", {}).get("ambient_sounds", [])) + 4, 8),
    }
    renderer = RendererSystem(engine)
    engine.add_system(renderer)
    anim = AnimationSystem(engine, renderer=renderer)
    engine.add_system(anim)
    engine.add_system(PhysicsSystem(engine))
    engine.add_system(NavigationSystem(engine))
    engine.add_system(GuiSystem(engine))
    audio = AudioSystem(engine)
    engine.add_system(audio)
    engine.add_system(ScriptSystem(engine))
    engine.add_system(CoreSystem(engine))
    report: Counter = Counter()
    assets = SceneAssets(renderer, anim=anim, audio_system=audio,
                         data_dirs=data_dirs, report=report)
    return engine, assets, n_ents


def instantiate_scene(scene: Dict[str, Any], data_dirs: Optional[Tuple[str, ...]] = None,
                      device="cuda", base_path: str = ".") -> InstantiatedScene:
    engine, assets, n_ents = build_engine_for_scene(scene, data_dirs, device, base_path)
    data_dirs = assets.data_dirs
    lua_sc = scene.get("lua_script", {})
    spawn_hr = 384 if (lua_sc.get("scripts") or lua_sc.get("inline_scripts")) else 0
    world = engine.create_world(capacity=n_ents + 16 + spawn_hr)
    emap = populate_world(scene, world, assets, data_dirs)
    return InstantiatedScene(engine=engine, world=world, emap=emap,
                             report=assets.report, assets=assets, scene=scene)


def instantiate_additive(engine, world, path: str,
                         data_dirs: Optional[Tuple[str, ...]] = None):
    """≙ World::load (world.cpp partition load, driven from Lua by
    `this.world:load(path, cb)` — demo/maps/main/button.lua): parse another
    .unv and instantiate its entities/components into an EXISTING world.
    Raises RuntimeError when the world lacks entity capacity. Returns the
    source→world entity map; the caller owns marking script structure dirty
    so the runner re-traces the step."""
    from lumixengine_tpu_torch.importers.unv import load_unv

    scene = load_unv(path)
    need = len(scene["entities"])
    free = world.capacity - world.entity_count
    if need > free:
        raise RuntimeError(
            f"additive load {path!r}: {need} entities > {free} free slots")
    if data_dirs is None:
        data_dirs = (engine.fs.base_path,)
    sm_ = engine.system_manager
    assets = SceneAssets(sm_.get_system("renderer_system"),
                         anim=sm_.get_system("animation_system"),
                         audio_system=sm_.get_system("audio_system"),
                         data_dirs=data_dirs, report=Counter())
    return populate_world(scene, world, assets, data_dirs, fresh=False)


def populate_world(scene: Dict[str, Any], world, assets: SceneAssets,
                   data_dirs: Tuple[str, ...] = (),
                   fresh: bool = True) -> Dict[int, int]:
    """Instantiate every entity/component/script of a parsed .unv into
    `world` (the shared body of fresh and additive loads). Returns the
    source-id → world-entity map; counts land in assets.report."""
    report = assets.report

    # pre-pass: entities that animate need their model path marked skinned so
    # placeholder models get skeletons
    ent_model: Dict[int, str] = {}
    r = scene.get("renderer", {})
    for mi in r.get("model_instances", []):
        if mi["model"]:
            ent_model[mi["entity"]] = mi["model"]
    a = scene.get("animation", {})
    for rec in a.get("animables", []) + a.get("animators", []):
        mp = ent_model.get(rec["entity"])
        if mp:
            assets.mark_skinned(mp)

    # -- entities / names / hierarchy (≙ world.cpp deserialize) ----------------
    # named partitions (world.cpp:1030-1032): handle -> local partition index
    part_idx: Dict[int, int] = {}
    if fresh and scene.get("partitions"):
        world.partitions = [p["name"] for p in scene["partitions"]]
        part_idx = {p["handle"]: i for i, p in enumerate(scene["partitions"])}
        world.active_partition = part_idx.get(
            scene.get("active_partition", 0), 0)
    emap: Dict[int, int] = {}
    for ent in scene["entities"]:
        e = world.create_entity(
            position=np.asarray(ent["pos"], np.float32),
            rotation=np.asarray(ent["rot"], np.float32),
            scale=np.asarray(ent["scale"], np.float32),
        )
        emap[ent["entity"]] = e
        if "partition" in ent:
            world.partition_of[e] = part_idx.get(ent["partition"],
                                                 ent["partition"])
        report["entities"] += 1
    for sid, name in scene["names"].items():
        if sid in emap:
            world.names[emap[sid]] = name
    for h in scene["hierarchy"]:
        c = emap.get(h["entity"])
        p = emap.get(h["parent"])
        if c is None or p is None:
            continue
        world.parent[c] = p
        world.local_pos[c] = np.asarray(h["local_pos"], np.float32)
        world.local_rot[c] = hm.quat_normalize(np.asarray(h["local_rot"], np.float32))
        world.local_scale[c] = np.asarray(h["local_scale"], np.float32)
        world._levels_dirty = True
        report["hierarchy"] += 1

    def ent(sid: int) -> Optional[int]:
        return emap.get(sid)

    # -- renderer ---------------------------------------------------------------
    for c in r.get("cameras", []):
        e = ent(c["entity"])
        if e is None:
            continue
        world.create_component(e, "camera", fov=c["fov"], near=c["near"],
                               far=c["far"], ortho_size=c.get("ortho_size", 10.0),
                               is_ortho=bool(c.get("is_ortho", False)))
        report["camera"] += 1
    for mi in r.get("model_instances", []):
        e = ent(mi["entity"])
        if e is None or not mi["model"]:
            continue
        world.create_component(e, "model_instance",
                               model=assets.model_id(mi["model"]))
        report["model_instance"] += 1
    for pl in r.get("point_lights", []):
        e = ent(pl["entity"])
        if e is None:
            continue
        world.create_component(e, "point_light", color=np.asarray(pl["color"], np.float32),
                               intensity=pl["intensity"], range=pl["range"],
                               fov=pl.get("fov", 6.2831855),
                               attenuation=pl.get("attenuation", 1.0))
        report["point_light"] += 1
    for env in r.get("environments", []):
        e = ent(env["entity"])
        if e is None:
            continue
        world.create_component(e, "environment",
                               color=np.asarray(env["light_color"], np.float32),
                               intensity=env["direct_intensity"])
        report["environment"] += 1
    for t in r.get("terrains", []):
        e = ent(t["entity"])
        if e is None:
            continue
        heights = None
        # the heightmap lives in the terrain material's texture; a .raw next
        # to the material is the common layout
        if heights is None:
            heights = np.zeros((64, 64), np.float32)
            report["terrain_placeholder_heightmap"] += 1
        tid = assets.renderer.terrains.add(heights, xz_scale=t["xz_scale"],
                                           y_scale=t["y_scale"])
        world.create_component(e, "terrain", terrain=tid)
        report["terrain"] += 1
    for pe in r.get("particle_emitters", []):
        e = ent(pe["entity"])
        if e is None:
            continue
        script = assets.particle_script(pe["resource"]) if pe["resource"] else None
        if script is None:
            report["particle_emitter_skipped"] += 1
            continue
        world.create_component(e, "particle_emitter", script=script)
        report["particle_emitter"] += 1
    for ba in r.get("bone_attachments", []):
        e = ent(ba["entity"])
        pe_ = ent(ba.get("parent_entity", -1))
        if e is None or pe_ is None:
            continue
        rel = ba["relative_transform"]
        # serialized bone reference is BoneNameHash (= XXH3 of the bone name,
        # render_module.cpp:506); resolve against the parent's skeleton
        bone_idx = ba.get("bone_index", 0)
        h = int(ba.get("bone_name_hash", 0) or 0)
        if h and ba.get("parent_entity", -1) in ent_model:
            from lumixengine_tpu_torch.core.hash import bone_name_hash as _bnh

            sk = assets.model_skeleton(ent_model[ba["parent_entity"]])
            if sk is not None:
                for bi, bn in enumerate(getattr(sk, "bone_names", [])):
                    if _bnh(bn) == h:
                        bone_idx = bi
                        break
        world.create_component(e, "bone_attachment", parent_entity=pe_,
                               bone=bone_idx,
                               offset_pos=np.asarray(rel["pos"], np.float32),
                               offset_rot=np.asarray(rel["rot"], np.float32))
        report["bone_attachment"] += 1
    for epr in r.get("environment_probes", []):
        e = ent(epr["entity"])
        if e is None:
            continue
        world.create_component(e, "environment_probe",
                               inner=np.asarray(epr["inner_range"], np.float32),
                               outer=np.asarray(epr["outer_range"], np.float32))
        report["environment_probe"] += 1
    for rp in r.get("reflection_probes", []):
        e = ent(rp["entity"])
        if e is None:
            continue
        world.create_component(e, "reflection_probe", size=rp["size"],
                               half_extents=np.asarray(rp["half_extents"], np.float32))
        report["reflection_probe"] += 1
    for d in r.get("decals", []):
        e = ent(d["entity"])
        if e is None:
            continue
        world.create_component(e, "decal",
                               half_extents=np.asarray(d["half_extents"], np.float32),
                               uv_scale=np.asarray(d.get("uv_scale", (1.0, 1.0)), np.float32))
        report["decal"] += 1
    for cd in r.get("curve_decals", []):
        e = ent(cd["entity"])
        if e is None:
            continue
        world.create_component(e, "curve_decal",
                               uv_scale=np.asarray(cd["uv_scale"], np.float32),
                               bezier_p0=np.asarray(cd["bezier_p0"], np.float32),
                               bezier_p2=np.asarray(cd["bezier_p2"], np.float32))
        report["curve_decal"] += 1
    for im in r.get("instanced_models", []):
        e = ent(im["entity"])
        if e is None or not im["model"]:
            continue
        inst = im["instances"]  # [N,8]: quat xyz (w derived), lod, pos, scale
        qxyz = inst[:, 0:3]
        w2 = np.maximum(1.0 - np.sum(qxyz * qxyz, axis=1), 0.0)
        rot = np.concatenate([qxyz, np.sqrt(w2)[:, None]], axis=1)
        world.create_component(
            e, "instanced_model", model=assets.model_id(im["model"]),
            count=inst.shape[0], positions=inst[:, 4:7], rotations=rot,
            scales=np.repeat(inst[:, 7:8], 3, axis=1))
        report["instanced_model"] += 1
    for pg in r.get("procedural_geometries", []):
        e = ent(pg["entity"])
        if e is None:
            continue
        world.create_component(e, "procedural_geometry")
        report["procedural_geometry"] += 1

    # -- physics ------------------------------------------------------------------
    p = scene.get("physics", {})
    pmod = world.modules.get("physics")
    for act_ in p.get("actors", []):
        e = ent(act_["entity"])
        if e is None or not act_["geoms"]:
            if e is not None:
                report["actor_no_geom"] += 1
            continue
        g = act_["geoms"][0]
        if len(act_["geoms"]) > 1:
            report["actor_extra_geoms"] += len(act_["geoms"]) - 1
        motion = {0: "static", 1: "dynamic", 2: "kinematic"}[act_["dynamic_type"]]
        ccd = act_.get("ccd", False)  # PxRigidBodyFlag::eENABLE_CCD
        if g["type"] == 0:
            world.create_component(e, "rigid_actor", motion=motion, shape="sphere",
                                   radius=g["radius"], layer=act_["layer"], ccd=ccd)
        elif g["type"] == 3:
            world.create_component(e, "rigid_actor", motion=motion, shape="box",
                                   half_extents=np.asarray(g["half_extents"], np.float32),
                                   layer=act_["layer"], ccd=ccd)
        else:
            # convex(4)/trimesh(5): cook from the entity's model geometry
            # (≙ physics_system.cpp cookConvex/cookTriMesh on the same source
            # mesh); bounding-box fallback when no vertex data is available
            mp = ent_model.get(act_["entity"], "")
            mo = assets.renderer.models.get(assets.model_id(mp)) if mp else None
            vpos = getattr(mo, "vertex_positions", None) if mo is not None else None
            if vpos is not None and len(vpos) >= 4 and g["type"] == 4:
                world.create_component(e, "rigid_actor", motion=motion,
                                       shape="convex", points=vpos,
                                       layer=act_["layer"], ccd=ccd)
                report["actor_convex"] += 1
            elif vpos is not None and len(vpos) >= 4 and g["type"] == 5:
                tris = getattr(mo, "vertex_triangles", None)
                if tris is None:
                    # no index data: SDF of the convex hull's surface
                    from scipy.spatial import ConvexHull
                    hull = ConvexHull(np.asarray(vpos, np.float64))
                    vpos, tris = hull.points, hull.simplices
                world.create_component(e, "mesh_collider", vertices=vpos,
                                       triangles=tris)
                report["mesh_collider"] += 1
            else:
                radius = mo.bounding_radius if mo is not None else 1.0
                he = radius / np.sqrt(3.0)
                world.create_component(e, "rigid_actor", motion=motion, shape="box",
                                       half_extents=(he, he, he), layer=act_["layer"])
                report["actor_mesh_approx"] += 1
        report["rigid_actor"] += 1
    for c in p.get("controllers", []):
        e = ent(c["entity"])
        if e is None:
            continue
        grav = -9.81
        if c.get("custom_gravity"):
            grav = -abs(c.get("custom_gravity_acceleration", 9.81))
        world.create_component(e, "physics_controller", radius=c["radius"],
                               height=c["height"], gravity=grav)
        report["physics_controller"] += 1
    for hf in p.get("heightfields", []):
        e = ent(hf["entity"])
        if e is None:
            continue
        world.create_component(e, "heightfield", terrain=0)
        report["heightfield"] += 1
    for j in p.get("joints", []):
        e = ent(j["entity"])
        ce = ent(j["connected_body"])
        if e is None or ce is None:
            report["joint_skipped"] += 1
            continue
        if pmod is None or pmod.actors.slot_of(e) < 0 or pmod.actors.slot_of(ce) < 0:
            report["joint_skipped"] += 1
            continue
        kind = {"spherical": "spherical_joint", "hinge": "hinge_joint",
                "distance": "distance_joint", "d6": "d6_joint"}[j["kind"]]
        f0 = j["local_frame0"]
        # anchor_b: connected body's local point coinciding with the anchor now
        pa_, ra_, _ = world.get_global_transform(e)
        pb_, rb_, _ = world.get_global_transform(ce)
        world_anchor = pa_ + hm.quat_rotate(ra_, np.asarray(f0["pos"], np.float32))
        anchor_b = hm.quat_rotate(hm.quat_conjugate(rb_), world_anchor - pb_)
        length = float(np.linalg.norm(world_anchor - pb_))
        axis = hm.quat_rotate(np.asarray(f0["rot"], np.float32),
                                  np.asarray((1.0, 0.0, 0.0), np.float32))
        extra = {}
        if j["kind"] == "hinge" and j.get("flags", 0) and "limit" in j:
            # PxJointAngularLimitPair: 5 base params + upper + lower
            lo, hi = sorted((j["limit"][6], j["limit"][5]))
            extra["limit"] = (lo, hi)
        if j["kind"] == "distance":
            if j.get("max_distance", 0.0) > 0:
                extra["min_distance"] = j.get("min_distance", 0.0)
                extra["max_distance"] = j["max_distance"]
        if j["kind"] == "d6" and "motions" in j:
            # PxD6Motion per axis (x,y,z,twist,swing1,swing2):
            # 0=LOCKED 1=LIMITED 2=FREE — LIMITED approximates as locked on
            # BOTH linear and angular axes (the conservative reading of
            # PxD6Joint::setMotion: a limited axis is constrained, not free)
            m = j["motions"]
            extra["linear_motion"] = tuple(int(v != 2) for v in m[0:3])
            extra["angular_motion"] = tuple(int(v != 2) for v in m[3:6])
        world.create_component(world.create_entity(name=f"joint{e}"), kind,
                               body_a=e, body_b=ce,
                               anchor_a=np.asarray(f0["pos"], np.float32),
                               anchor_b=anchor_b, axis=axis,
                               length=max(length, 1e-3), **extra)
        report["joint"] += 1
    for v in p.get("vehicles", []):
        e = ent(v["entity"])
        if e is None:
            continue
        world.create_component(e, "vehicle", mass=v["mass"],
                               center_of_mass=np.asarray(v["center_of_mass"], np.float32),
                               moi_multiplier=v["moi_multiplier"],
                               chassis_layer=v["chassis_layer"],
                               wheels_layer=v["wheels_layer"],
                               peak_torque=v.get("peak_torque", 500.0),
                               max_rpm=v.get("max_rpm", 6000.0))
        report["vehicle"] += 1
    for wrec in p.get("wheels", []):
        e = ent(wrec["entity"])
        if e is None:
            continue
        world.create_component(e, "wheel", radius=wrec["radius"],
                               width=wrec["width"], mass=wrec["mass"],
                               moi=wrec["moi"], max_droop=wrec["max_droop"],
                               max_compression=wrec["max_compression"],
                               spring_strength=wrec["spring_strength"],
                               spring_damper_rate=wrec["spring_damper_rate"],
                               slot=wrec["slot"])
        report["wheel"] += 1
    # instanced static collision (≙ physics_module.cpp:3572-3591 deserialize
    # → initInstancedCubes/initInstancedMeshes at startGame): the physics
    # module materializes one static actor per render InstancedModel instance
    for ic in p.get("instanced_cubes", []):
        e = ent(ic["entity"])
        if e is None:
            continue
        world.create_component(e, "instanced_cube",
                               half_extents=np.asarray(ic["half_extents"],
                                                       np.float32),
                               layer=int(ic["layer"]))
        report["instanced_cube"] += 1
    for imh in p.get("instanced_meshes", []):
        e = ent(imh["entity"])
        if e is None:
            continue
        world.create_component(e, "instanced_mesh", mesh=imh.get("mesh", ""),
                               layer=int(imh["layer"]))
        report["instanced_mesh"] += 1

    # -- animation ------------------------------------------------------------------
    for an in a.get("animables", []):
        e = ent(an["entity"])
        mp = ent_model.get(an["entity"])
        if e is None or mp is None or not an["animation"]:
            report["animable_skipped"] += 1
            continue
        world.create_component(e, "animable",
                               clip=assets.clip_id(an["animation"], mp))
        report["animable"] += 1
    for an in a.get("animators", []):
        e = ent(an["entity"])
        mp = ent_model.get(an["entity"])
        if e is None or mp is None or not an["controller"]:
            report["animator_skipped"] += 1
            continue
        world.create_component(e, "animator",
                               controller=assets.controller_id(an["controller"], mp))
        report["animator"] += 1
    for pa in a.get("property_animators", []):
        e = ent(pa["entity"])
        path = assets.find_file(pa["animation"]) if pa.get("animation") else None
        if e is None or path is None:
            report["property_animator_skipped"] += 1
            continue
        from lumixengine_tpu_torch.importers.anp import parse_anp, to_component_curves
        with open(path, "r", errors="replace") as f:
            curves = to_component_curves(parse_anp(f.read()))
        if not curves:
            report["property_animator_skipped"] += 1
            continue
        world.create_component(e, "property_animator", curves=curves)
        report["property_animator"] += 1

    # -- navigation --------------------------------------------------------------
    nav = scene.get("navigation", {})
    for z in nav.get("zones", []):
        e = ent(z["entity"])
        if e is None:
            continue
        ex = np.asarray(z["extents"], np.float32)
        pos, _, _ = world.get_global_transform(e)
        cell = max(float(z.get("cell_size", 0.3)) * 2.0, 0.5)
        # guid keys the shipped compiled navmesh (navzones/<guid>.nav, ≙
        # NavigationModule::loadZone) — the module rasterizes its walkable
        # polygon set into the zone grid when the file is found
        world.create_component(e, "nav_zone",
                               origin=(pos[0] - ex[0], pos[2] - ex[2]),
                               size=(2 * ex[0], 2 * ex[2]), cell=cell,
                               guid=int(z.get("guid", 0)),
                               nav_dirs=data_dirs)
        report["nav_zone"] += 1
    for ag in nav.get("agents", []):
        e = ent(ag["entity"])
        if e is None:
            continue
        world.create_component(e, "nav_agent", radius=ag["radius"])
        report["nav_agent"] += 1

    # -- gui ------------------------------------------------------------------------
    g = scene.get("gui", {})
    for rect in g.get("rects", []):
        e = ent(rect["entity"])
        if e is None:
            continue
        world.create_component(
            e, "gui_rect",
            anchor=(rect["left"]["relative"], rect["top"]["relative"],
                    rect["right"]["relative"], rect["bottom"]["relative"]),
            offset=(rect["left"]["points"], rect["top"]["points"],
                    rect["right"]["points"], rect["bottom"]["points"]),
            enabled=bool(rect["flags"] & 1))
        report["gui_rect"] += 1
        if "image" in rect:
            world.create_component(e, "gui_image",
                                   color=_u32_color(rect["image"]["color"]))
            report["gui_image"] += 1
        if "text" in rect:
            world.create_component(e, "gui_text", text=rect["text"]["text"],
                                   font_size=rect["text"]["font_size"],
                                   color=_u32_color(rect["text"]["color"]))
            report["gui_text"] += 1
        if rect.get("input_field"):
            world.create_component(e, "gui_input_field")
            report["gui_input_field"] += 1
    for b in g.get("buttons", []):
        e = ent(b["entity"])
        if e is None:
            continue
        world.create_component(e, "gui_button",
                               hovered_color=_u32_color(b["hovered_color"]))
        report["gui_button"] += 1
    report["gui_canvas"] += len(g.get("canvases", []))

    # -- audio -------------------------------------------------------------------
    au = scene.get("audio", {})
    if au:
        le = ent(au.get("listener", -1))
        if le is not None:
            world.create_component(le, "listener")
            report["listener"] += 1
        for snd in au.get("ambient_sounds", []):
            e = ent(snd["entity"])
            if e is None:
                continue
            world.create_component(e, "ambient_sound",
                                   clip=assets.audio_clip_id(snd["clip"]),
                                   is_3d=snd["is_3d"])
            report["ambient_sound"] += 1
        for z in au.get("echo_zones", []):
            e = ent(z["entity"])
            if e is None:
                continue
            world.create_component(e, "echo_zone", radius=z["radius"])
            report["echo_zone"] += 1
        for z in au.get("chorus_zones", []):
            e = ent(z["entity"])
            if e is None:
                continue
            world.create_component(e, "chorus_zone", radius=z["radius"])
            report["chorus_zone"] += 1

    # -- scripts: the reference's Luau sources EXECUTE through the clean-room
    # Lua interpreter (script/lua) behind the bridge API (script/lua_bridge),
    # ≙ lua_script_system.cpp: env setup → chunk run → stored properties
    # applied → start() on game start -----------------------------------------
    lua = scene.get("lua_script", {})
    sm = world.modules.get("script")
    if sm is not None:
        sm.lua_search_dirs = list(data_dirs)
        sm.set_asset_bank(assets)

    def _lua_prop_value(pp):
        v = pp.get("value")
        t = pp.get("type")
        if t == "ENTITY":
            ids = v if isinstance(v, list) else [v]
            handles = [sm.lua_entity(ent(i) if ent(i) is not None else -1)
                       for i in ids]
            return handles if isinstance(v, list) and pp.get("is_array") else handles[0]
        if t == "RESOURCE":
            return sm.lua_resource(str(v))
        if t == "BOOLEAN":
            return bool(v)
        if t in ("FLOAT", "INT"):
            return float(v)
        return v

    for holder in lua.get("scripts", []):
        e = ent(holder["entity"])
        if e is None or sm is None:
            continue
        for s in holder["scripts"]:
            props = {}
            for pp in s["properties"]:
                # named when the .unv carries a name table; else the
                # StableHash64 of the name (resolved against chunk globals)
                name = pp["name"] or int(pp["name_hash"])
                try:
                    props[name] = _lua_prop_value(pp)
                except Exception:
                    props[name] = None
            sm.attach_lua_script(e, path=s["path"], properties=props)
            report["script"] += 1
    for isc in lua.get("inline_scripts", []):
        e = ent(isc["entity"])
        if e is None or sm is None:
            continue
        sm.attach_lua_script(e, source=isc["source"])
        report["inline_script"] += 1
    if fresh and sm is not None and sm._lua_rt is not None:
        # chunk execution is not a structural edit; spawns during play are.
        # (Additive loads keep the flags: the caller marks structure dirty
        # so the runner re-traces, and in-flight pending writes survive.)
        sm._lua_rt.structure_dirty = False
        sm._lua_rt.dirty_transforms.clear()

    # -- core ----------------------------------------------------------------------
    core = scene.get("core", {})
    for sp in core.get("splines", []):
        e = ent(sp["entity"])
        if e is None:
            continue
        world.create_component(e, "spline", points=sp["points"])
        report["spline"] += 1
    for sig in core.get("signals", []):
        e = ent(sig["entity"])
        if e is None:
            continue
        # ≙ core.cpp CoreModuleImpl::deserialize (SIGNALS block): the .unv
        # stores reflection-MODULE names for both ends of the connection.
        # dispatch_signals resolves module OR component scopes through the
        # registry (reflection.find_event/find_function); the only remap
        # needed here is reference module names that differ from this
        # engine's (lua_script → script).
        _mod_names = {"lua_script": "script"}
        world.create_component(
            e, "signal",
            event_component=_mod_names.get(sig["event_module"],
                                           sig["event_module"]),
            event=sig["event"],
            function_component=_mod_names.get(sig["function_module"],
                                              sig["function_module"]),
            function=sig["function"], target_entity=e)
        report["signal"] += 1

    return emap


def load_world(path: str, data_dirs: Optional[Tuple[str, ...]] = None, device="cuda",
               base_path: str = ".") -> InstantiatedScene:
    """One-call load: parse the .unv and instantiate (≙ Runner::loadWorld)."""
    from lumixengine_tpu_torch.importers.unv import load_unv

    return instantiate_scene(load_unv(path), data_dirs=data_dirs, device=device,
                             base_path=base_path)


def export_scene(inst: InstantiatedScene) -> Dict[str, Any]:
    """Write the live World back into the retained parsed scene dict — the
    editor-save path (≙ WorldEditor save → world.cpp:837-897 serialize).

    Covered: entity global transforms (f32 precision — the World stores
    float32, the .unv field is DVec3), names, partition tags, hierarchy
    (parents, rebuilt first_child/next_sibling links, local transforms),
    pruning of destroyed entities from every module's component records, and
    entities created after load (fresh source ids; camera / point_light /
    model_instance components export — other component types on NEW entities
    are counted in ``_export_new_entities`` for the caller to surface).
    """
    import copy

    assert inst.scene is not None, "scene dict not retained (old save file?)"
    world = inst.world
    scene = copy.deepcopy(inst.scene)

    alive = {s: e for s, e in inst.emap.items() if world.is_alive(e)}
    dead = {s for s in inst.emap if s not in alive}
    inv0 = {e: s for s, e in alive.items()}

    # entities created after load: fresh source ids past the existing range
    next_src = max([en["entity"] for en in scene["entities"]] or [-1]) + 1
    new_map: Dict[int, int] = {}
    for e in range(world.capacity):
        if world.is_alive(e) and e not in inv0:
            new_map[e] = next_src
            next_src += 1
    for e, s in new_map.items():
        alive[s] = e

    # partitions: if the world uses them (additive loads create them), the
    # save carries the named table + per-entity tags (≙ HAS_PARTITIONS flag)
    has_parts = bool(scene.get("flags", 0) & 1)
    # only LIVE entities' partition tags count — destroy_entity leaves stale
    # tags behind (ADVICE-r3 low #5)
    _live = np.zeros(world.capacity, bool)
    for e in alive.values():
        _live[e] = True
    if len(world.partitions) > 1 or world.partition_of[:world.capacity][_live].any():
        has_parts = True
        scene["flags"] = scene.get("flags", 0) | 1
    if has_parts:
        scene["partitions"] = [{"handle": i, "name": n}
                               for i, n in enumerate(world.partitions)]
        scene["active_partition"] = int(world.active_partition)
    ents = []
    for ent in scene["entities"]:
        e = alive.get(ent["entity"])
        if e is None:
            continue
        pos, rot, scale = world.get_global_transform(e)
        ent["pos"] = tuple(float(x) for x in pos)
        ent["rot"] = tuple(float(x) for x in rot)
        ent["scale"] = tuple(float(x) for x in scale)
        if "partition" in ent or has_parts:
            ent["partition"] = int(world.partition_of[e])
        ents.append(ent)
    for e, s in sorted(new_map.items(), key=lambda kv: kv[1]):
        pos, rot, scale = world.get_global_transform(e)
        rec = {"entity": s, "pos": tuple(float(x) for x in pos),
               "rot": tuple(float(x) for x in rot),
               "scale": tuple(float(x) for x in scale)}
        if has_parts:
            rec["partition"] = int(world.partition_of[e])
        ents.append(rec)
    scene["entities"] = ents

    # live component property write-back for SURVIVING entities: editor
    # set_property edits land in the stores, not the parsed records — read
    # them back so "edit → save → reload" round-trips (ADVICE-r3 medium #2;
    # ≙ the reference serializing FROM the live module state)
    rmod = world.modules.get("renderer")
    rsc = scene.get("renderer")
    if rmod is not None and rsc is not None:
        for c in rsc.get("cameras", []):
            e = alive.get(c["entity"])
            if e is None or rmod.cameras.slot_of(e) < 0:
                continue
            for f in ("fov", "near", "far", "ortho_size"):
                c[f] = float(rmod.cameras.get(e, f))
            c["is_ortho"] = bool(rmod.cameras.get(e, "is_ortho"))
        for pl in rsc.get("point_lights", []):
            e = alive.get(pl["entity"])
            if e is None or rmod.point_lights.slot_of(e) < 0:
                continue
            pl["color"] = tuple(float(x)
                                for x in rmod.point_lights.get(e, "color"))
            for f in ("intensity", "range", "fov", "attenuation"):
                pl[f] = float(rmod.point_lights.get(e, f))
        for env in rsc.get("environments", []):
            e = alive.get(env["entity"])
            if e is None or e != rmod.env_entity:
                continue
            env["light_color"] = tuple(float(x) for x in rmod.env_color)
            env["direct_intensity"] = float(rmod.env_intensity)
        path_of_model_live = {v: k for k, v in inst.assets._model_ids.items()}
        for mi in rsc.get("model_instances", []):
            e = alive.get(mi["entity"])
            if e is None or rmod.model_instances.slot_of(e) < 0:
                continue
            live = path_of_model_live.get(
                int(rmod.model_instances.get(e, "model")))
            if live:
                mi["model"] = live
        for key, store in (("decals", rmod.decals),
                           ("curve_decals", rmod.curve_decals)):
            for d in rsc.get(key, []):
                e = alive.get(d["entity"])
                if e is None or store.slot_of(e) < 0:
                    continue
                d["half_extents"] = tuple(float(x)
                                          for x in store.get(e, "half_extents"))
                d["uv_scale"] = tuple(float(x)
                                      for x in store.get(e, "uv_scale"))
    pmod_wb = world.modules.get("physics")
    psc_wb = scene.get("physics")
    if pmod_wb is not None and psc_wb is not None:
        for a in psc_wb.get("actors", []):
            e = alive.get(a["entity"])
            if e is None or pmod_wb.actors.slot_of(e) < 0:
                continue
            a["dynamic_type"] = int(pmod_wb.actors.get(e, "motion"))
            a["layer"] = int(pmod_wb.actors.get(e, "layer"))
            a["ccd"] = bool(pmod_wb.actors.get(e, "ccd"))
    cmod_wb = world.modules.get("core")
    if cmod_wb is not None and "core" in scene:
        for sp in scene["core"].get("splines", []):
            e = alive.get(sp["entity"])
            if e is not None and e in cmod_wb.splines:
                sp["points"] = cmod_wb.splines[e].tolist()

    # common renderer components on NEW entities export directly
    exported_new = 0
    if rmod is not None and rsc is not None:
        path_of_model = {v: k for k, v in inst.assets._model_ids.items()}
        # fresh light guids above every existing one (guid collisions break
        # the reference's shadow-atlas keying)
        next_guid = max([int(p.get("guid", 0))
                         for p in rsc.get("point_lights", [])] or [0]) + 1
        for e, s in new_map.items():
            if rmod.cameras.slot_of(e) >= 0:
                rsc["cameras"].append({
                    "entity": s, "fov": float(rmod.cameras.get(e, "fov")),
                    "near": float(rmod.cameras.get(e, "near")),
                    "far": float(rmod.cameras.get(e, "far")),
                    "ortho_size": float(rmod.cameras.get(e, "ortho_size")),
                    "screen_width": 1920.0, "screen_height": 1080.0,
                    "is_ortho": bool(rmod.cameras.get(e, "is_ortho")),
                    "film_grain_intensity": 0.0, "dof_enabled": False,
                    "dof_distance": 10.0, "dof_range": 5.0,
                    "dof_max_blur_size": 10.0, "dof_sharp_range": 1.0})
                exported_new += 1
            if rmod.point_lights.slot_of(e) >= 0:
                rsc["point_lights"].append({
                    "color": tuple(float(x)
                                   for x in rmod.point_lights.get(e, "color")),
                    "intensity": float(rmod.point_lights.get(e, "intensity")),
                    "entity": s,
                    "fov": float(rmod.point_lights.get(e, "fov")),
                    "attenuation": float(rmod.point_lights.get(e, "attenuation")),
                    "range": float(rmod.point_lights.get(e, "range")),
                    "flags": 0, "guid": next_guid})
                next_guid += 1
                exported_new += 1
            mid = rmod.model_instances.slot_of(e)
            if mid >= 0:
                path = path_of_model.get(
                    int(rmod.model_instances.get(e, "model")), "")
                rsc["model_instances"].append(
                    {"entity": s, "flags": 6, "model": path,
                     "material_overrides": []})
                exported_new += 1

    # new rigid actors with analytic geoms export too (sphere → px type 0,
    # box → px type 3; convex/capsule need cooked-mesh paths, skipped)
    pmod = world.modules.get("physics")
    psc = scene.get("physics")
    if pmod is not None and psc is not None:
        from lumixengine_tpu_torch.ops import physics_ops as _P
        _identity = {"pos": (0.0, 0.0, 0.0), "rot": (0.0, 0.0, 0.0, 1.0)}
        for e, s in new_map.items():
            if pmod.actors.slot_of(e) < 0:
                continue
            shape = int(pmod.actors.get(e, "shape"))
            if shape == _P.SHAPE_SPHERE:
                geom = {"type": 0, "index": 0, "local": dict(_identity),
                        "radius": float(pmod.actors.get(e, "radius"))}
            elif shape == _P.SHAPE_BOX:
                geom = {"type": 3, "index": 0, "local": dict(_identity),
                        "half_extents": tuple(
                            float(x)
                            for x in pmod.actors.get(e, "half_extents"))}
            else:
                continue
            psc["actors"].append({
                "entity": s,
                "dynamic_type": int(pmod.actors.get(e, "motion")),
                "is_trigger": False, "ccd": bool(pmod.actors.get(e, "ccd")),
                "layer": int(pmod.actors.get(e, "layer")), "material": "",
                "mesh": "", "geoms": [geom]})
            exported_new += 1

    scene["names"] = {s: world.get_entity_name(e)
                      for s, e in alive.items() if world.get_entity_name(e)}

    # hierarchy: rebuild records + sibling links from the live parent arrays
    inv = {e: s for s, e in alive.items()}
    children: Dict[int, List[int]] = {}
    parent_of: Dict[int, int] = {}
    for s, e in alive.items():
        p = int(world.parent[e])
        ps = inv.get(p, -1) if p >= 0 else -1
        if ps >= 0:
            parent_of[s] = ps
            children.setdefault(ps, []).append(s)
    participants = sorted(set(parent_of) | set(children))
    hier = []
    for s in participants:
        sibs = children.get(parent_of.get(s, -1), [])
        idx = sibs.index(s) if s in sibs else -1
        nxt = sibs[idx + 1] if 0 <= idx < len(sibs) - 1 else -1
        lp, lr, ls = world.get_local_transform(alive[s])
        hier.append({
            "entity": s, "parent": parent_of.get(s, -1),
            "first_child": children.get(s, [-1])[0],
            "next_sibling": nxt,
            "local_pos": tuple(float(x) for x in lp),
            "local_rot": tuple(float(x) for x in lr),
            "local_scale": tuple(float(x) for x in ls)})
    scene["hierarchy"] = hier

    # prune destroyed entities from every module's component records, and
    # null out surviving records' references to them (joints'
    # connected_body, bone attachments' parent_entity, Lua ENTITY props) —
    # ≙ the reference serializing an invalid EntityPtr as -1
    if dead:
        _ref_fields = ("connected_body", "parent_entity", "target_entity")
        for mname in scene.get("_module_order", []):
            mod = scene.get(mname)
            if not isinstance(mod, dict):
                continue
            for key, val in mod.items():
                if isinstance(val, list):
                    mod[key] = [rec for rec in val
                                if not (isinstance(rec, dict)
                                        and rec.get("entity") in dead)]
                    for rec in mod[key]:
                        if not isinstance(rec, dict):
                            continue
                        for f in _ref_fields:
                            if rec.get(f) in dead:
                                rec[f] = -1
        for sc_ in scene.get("lua_script", {}).get("scripts", []):
            for s_ in sc_["scripts"]:
                for p_ in s_["properties"]:
                    if p_["type"] != "ENTITY":
                        continue
                    if p_.get("is_array"):
                        p_["value"] = [-1 if v in dead else v
                                       for v in p_["value"]]
                    elif p_["value"] in dead:
                        p_["value"] = -1

    scene["_export_new_entities"] = len(new_map)
    scene["_export_new_components"] = exported_new
    return scene


def save_world_unv(inst: InstantiatedScene, path: str) -> None:
    """Save the live World as a reference-format .unv (≙ editor save)."""
    from lumixengine_tpu_torch.importers.unv_write import write_unv

    scene = export_scene(inst)
    scene.pop("_export_new_entities", None)
    scene.pop("_export_new_components", None)
    with open(path, "wb") as f:
        f.write(write_unv(scene))
