"""RenderModule + RendererSystem (counterpart of
``lumixengine_tpu/renderer/render_module.py``).

The ported components are model_instance, camera, point_light, environment,
particle_emitter, instanced_model (host instance blobs, culled as one sphere
each by ``pipeline.prepare_view``) and bone_attachment. The phases are
end_frame (previous-frame transforms of the model instances), update (one
frame of every particle emitter, with the particle counters), late_update
(bone attachments follow their animated bone) and the pipeline's cull pass.
Other component types raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from lumixengine_tpu_torch.core import math as lm
from lumixengine_tpu_torch.core import random as prng
from lumixengine_tpu_torch.engine.plugin import IModule, ISystem
from lumixengine_tpu_torch.engine.world import World, WorldState
from lumixengine_tpu_torch.renderer.culling_system import CullingState, CullingSystem
from lumixengine_tpu_torch.renderer.model import Model, ModelRegistry
from lumixengine_tpu_torch.renderer.terrain import TerrainRegistry
from lumixengine_tpu_torch.utils.store import DenseStore

_NOT_PORTED = ("terrain", "decal", "curve_decal", "procedural_geometry", "reflection_probe",
               "environment_probe")


@dataclass
class RenderState:
    culling: CullingState
    mi_entity: torch.Tensor       # int32 [K]
    mi_model: torch.Tensor        # int32 [K]
    mi_visible: torch.Tensor      # bool [K] (output of the last cull pass)
    mi_lod: torch.Tensor          # int32 [K]
    prev_pos: torch.Tensor        # f32 [3,K] previous-frame world pos
    prev_rot: torch.Tensor        # f32 [4,K]
    cam_entity: torch.Tensor      # int32 [C]
    cam_fov: torch.Tensor         # f32 [C]
    cam_near: torch.Tensor
    cam_far: torch.Tensor
    cam_aspect: torch.Tensor
    cam_ortho_size: torch.Tensor
    cam_is_ortho: torch.Tensor    # bool [C]
    pl_entity: torch.Tensor       # int32 [L]
    pl_color: torch.Tensor        # f32 [3,L]
    pl_intensity: torch.Tensor
    pl_range: torch.Tensor
    pl_visible: torch.Tensor      # bool [L]
    env_entity: torch.Tensor      # int32 []
    env_color: torch.Tensor       # f32 [3]
    env_intensity: torch.Tensor   # f32 []
    particles: Dict[str, Any]     # component key -> {emitter name -> EmitterState}
    prng: torch.Tensor            # uint32 [2] key of the particle randomness
    counters: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "RenderState":
        return dataclasses.replace(self, **kw)


class RenderModule(IModule):
    name = "renderer"

    def __init__(self, world: World, system: "RendererSystem", max_model_instances: int = 4096,
                 max_cameras: int = 4, max_point_lights: int = 256):
        super().__init__(world, system)
        self.culling = CullingSystem(max_model_instances)
        self.model_instances = DenseStore(max_model_instances, {"model": ((), np.int32, -1)})
        self.cameras = DenseStore(max_cameras, {
            "fov": ((), np.float32, np.radians(60.0)),
            "near": ((), np.float32, 0.1),
            "far": ((), np.float32, 10000.0),
            "aspect": ((), np.float32, 16.0 / 9.0),
            "ortho_size": ((), np.float32, 10.0),
            "is_ortho": ((), np.bool_, False),
        })
        self.point_lights = DenseStore(max_point_lights, {
            "color": ((3,), np.float32, 1.0),
            "intensity": ((), np.float32, 1.0),
            "range": ((), np.float32, 10.0),
            "fov": ((), np.float32, 2.0 * np.pi),
            "attenuation": ((), np.float32, 1.0),
        })
        self.env_entity = -1
        self.env_color = np.ones(3, np.float32)
        self.env_intensity = np.float32(1.0)
        # particle emitter components: key -> (entity, ParticleSystem instance)
        self.particle_emitters: Dict[str, tuple] = {}
        # BoneAttachment: the entity follows a bone of an animated parent
        self.bone_attachments = DenseStore(64, {
            "parent_entity": ((), np.int32, -1),
            "bone": ((), np.int32, 0),
            "offset_pos": ((3,), np.float32, 0.0),
            "offset_rot": ((4,), np.float32, (0.0, 0.0, 0.0, 1.0)),
        })
        # InstancedModel: per-entity instance blobs (host arrays)
        self.instanced_models: Dict[int, dict] = {}
        self._statics = None
        self._statics_version = -1
        self._anim_statics = None     # the animation statics the view statics were built on

    def component_types(self):
        return ["model_instance", "camera", "point_light", "environment", "particle_emitter",
                "instanced_model", "bone_attachment", *_NOT_PORTED]

    def statics(self):
        """Host view statics (slot indices, model ids, radii, the attachment
        wiring), rebuilt on membership change here, in the hierarchy or in
        the animation module (whose pool columns the attachments read)."""
        self.world._refresh_levels()
        anim = self.world.modules.get("animation")
        anim_statics = anim.statics() if anim is not None else None
        if (self._statics is None or self._statics_version != self.world.topology_version
                or self._anim_statics is not anim_statics):
            from lumixengine_tpu_torch.renderer.pipeline import ViewStatics

            self._statics = ViewStatics(self)
            self._statics_version = self.world.topology_version
            self._anim_statics = anim_statics
        return self._statics

    def prepare_statics(self, device) -> None:
        self.statics().on(device)

    def create_component(self, entity: int, ctype: str, **props):
        self._statics = None
        if ctype == "model_instance":
            model_name = props.get("model")
            mid = (self.system.models.get_id(model_name) if isinstance(model_name, str)
                   else int(model_name))
            self.model_instances.add(entity, model=mid)
            self.culling.add(entity, self.system.models.get(mid).bounding_radius)
        elif ctype == "camera":
            self.cameras.add(entity, **props)
        elif ctype == "point_light":
            self.point_lights.add(entity, **props)
        elif ctype == "environment":
            self.env_entity = entity
            if "color" in props:
                self.env_color = np.asarray(props["color"], np.float32)
            if "intensity" in props:
                self.env_intensity = np.float32(props["intensity"])
        elif ctype == "particle_emitter":
            self.particle_emitters[f"pe{entity}"] = (entity,
                                                     self.system.particle_system(props["script"]))
        elif ctype == "instanced_model":
            mid = props.get("model")
            mid = self.system.models.get_id(mid) if isinstance(mid, str) else int(mid)
            n = int(props.get("count", 0))
            self.instanced_models[entity] = {
                "model": mid,
                "pos": np.asarray(props.get("positions", np.zeros((n, 3))), np.float32),
                "rot": np.asarray(props.get("rotations", np.tile([0, 0, 0, 1.0], (max(n, 1), 1))),
                                  np.float32),
                "scale": np.asarray(props.get("scales", np.ones((max(n, 1), 3))), np.float32),
            }
        elif ctype == "bone_attachment":
            parent = int(props.get("parent_entity", -1))
            self.bone_attachments.add(
                entity, parent_entity=np.int32(parent), bone=np.int32(props.get("bone", 0)),
                offset_pos=np.asarray(props.get("offset_pos", (0.0,) * 3), np.float32),
                offset_rot=np.asarray(props.get("offset_rot", (0, 0, 0, 1.0)), np.float32))
            # the attachment follows the bone in the animated entity's space
            if parent >= 0 and self.world.get_parent(entity) < 0:
                self.world.set_parent(entity, parent)
        else:
            raise NotImplementedError(f"render component {ctype!r} is not ported")

    def device_state(self, device) -> RenderState:
        w = self.world
        mi = self.model_instances.device(device, w)
        cam = self.cameras.device(device, w)
        pl = self.point_lights.device(device, w)
        k = self.model_instances.capacity
        prev_rot = torch.zeros((4, k), dtype=torch.float32, device=device)
        prev_rot[3] = 1.0

        def i32(x):
            return torch.tensor(x, dtype=torch.int32, device=device)

        return RenderState(
            culling=self.culling.device_state(device, w),
            mi_entity=mi["entity"], mi_model=mi["model"],
            mi_visible=torch.zeros(k, dtype=torch.bool, device=device),
            mi_lod=torch.zeros(k, dtype=torch.int32, device=device),
            prev_pos=torch.zeros((3, k), dtype=torch.float32, device=device),
            prev_rot=prev_rot,
            cam_entity=cam["entity"], cam_fov=cam["fov"], cam_near=cam["near"],
            cam_far=cam["far"], cam_aspect=cam["aspect"],
            cam_ortho_size=cam["ortho_size"], cam_is_ortho=cam["is_ortho"],
            pl_entity=pl["entity"], pl_color=pl["color"].T.contiguous(),
            pl_intensity=pl["intensity"], pl_range=pl["range"],
            pl_visible=torch.zeros(self.point_lights.capacity, dtype=torch.bool, device=device),
            env_entity=i32(w.slot(self.env_entity) if self.env_entity >= 0 else -1),
            env_color=torch.as_tensor(self.env_color, device=device),
            env_intensity=torch.as_tensor(self.env_intensity, device=device),
            particles={key: ps.device_state(device)
                       for key, (e, ps) in self.particle_emitters.items()},
            prng=prng.PRNGKey(0, device),
            counters={"visible_count": i32(0), "lights_visible": i32(0),
                      "particles_alive": i32(0), "particles_emitted": i32(0),
                      "particles_killed": i32(0)},
        )

    def end_frame(self, state: WorldState, dt) -> WorldState:
        """Snapshot the model instances' previous-frame world transforms."""
        rs: RenderState = state.modules[self.name]
        eidx = self.statics().on(state.world.pos.device).mi_index
        rs = rs.replace(prev_pos=state.world.pos.index_select(-1, eidx),
                        prev_rot=state.world.rot.index_select(-1, eidx))
        return state.replace(modules={**state.modules, self.name: rs})

    def late_update(self, state: WorldState, dt) -> WorldState:
        """Bone attachments follow their animated bone: the attachment's
        local transform (a child of the animated entity) = the bone's
        model-space pose ∘ the offset. Returns at once without attachments."""
        if not len(self.bone_attachments) or "animation" not in state.modules:
            return state
        statics = self.statics()
        if statics.ba_flat.size == 0:
            return state
        ams = state.modules["animation"]
        d = statics.on(ams.pose_pos.device)
        bpos = ams.pose_pos.flatten(-2).index_select(-1, d.ba_flat)   # [.., 3, A]
        brot = ams.pose_rot.flatten(-2).index_select(-1, d.ba_flat)   # [.., 4, A]
        new_lp = bpos + lm.quat_rotate(brot, d.ba_offset_pos, axis=-2)
        new_lr = lm.quat_mul(brot, d.ba_offset_rot, axis=-2)
        local = state.local.replace(pos=state.local.pos.index_copy(-1, d.ba_slots, new_lp),
                                    rot=state.local.rot.index_copy(-1, d.ba_slots, new_lr))
        return state.replace(local=local)

    def attachment_wiring(self):
        """The static wiring of the attachments whose parent is animated, on
        the host: (flat index bone · pool + column into the [.., B, P] pose
        pool int64 [A], world slot int64 [A], offset pos f32 [3, A], offset
        rot f32 [4, A])."""
        ba, anim = self.bone_attachments, self.world.modules.get("animation")
        flat, eslots, offp, offr = [], [], [], []
        for slot in np.nonzero(ba.entity >= 0)[0] if anim is not None else ():
            parent = int(ba.data["parent_entity"][slot])
            if parent in anim.animables:
                col = anim.pool_col_animable(anim.animables.slot_of(parent))
            elif parent in anim.animators:
                col = anim.pool_col_animator(anim.animators.slot_of(parent))
            else:
                continue
            flat.append(int(ba.data["bone"][slot]) * anim.pool_size + col)
            eslots.append(self.world.slot(int(ba.entity[slot])))
            offp.append(ba.data["offset_pos"][slot])
            offr.append(ba.data["offset_rot"][slot])
        return (np.asarray(flat, np.int64), np.asarray(eslots, np.int64),
                np.asarray(offp, np.float32).reshape(-1, 3).T.copy(),
                np.asarray(offr, np.float32).reshape(-1, 4).T.copy())

    def cull_pass(self, state: WorldState, dt) -> WorldState:
        """The pipeline's cull/LOD pass on camera 0 (kernel K1)."""
        from lumixengine_tpu_torch.renderer import pipeline as pipe

        return pipe.cull_pass(state, dt, self, statics=self.statics())

    def update(self, state: WorldState, dt) -> WorldState:
        """One frame of every particle emitter, in component-key order, each
        on its own key folded from the frame counter; the emitter's entity
        position is the script's `entity_position` (declared `global`s read
        zeros: nothing sets them)."""
        if not self.particle_emitters:
            return state
        rs: RenderState = state.modules[self.name]
        key = prng.fold_in(rs.prng, state.frame)
        particles = dict(rs.particles)
        alive_n = emitted_n = killed_n = torch.zeros_like(state.frame)
        for i, (pkey, (entity, ps)) in enumerate(sorted(self.particle_emitters.items())):
            system = {"entity_position": state.world.pos[..., :, self.world.slot(entity)]}
            sub = ps.step(particles[pkey], dt, state.time, prng.fold_in(key, i), system=system)
            particles[pkey] = sub
            for st in sub.values():
                alive_n = alive_n + torch.sum(st.alive, dim=-1, dtype=torch.int32)
                emitted_n = emitted_n + st.emitted
                killed_n = killed_n + st.killed
        rs = rs.replace(particles=particles, counters={
            **rs.counters, "particles_alive": alive_n, "particles_emitted": emitted_n,
            "particles_killed": killed_n})
        return state.replace(modules={**state.modules, self.name: rs})


class RendererSystem(ISystem):
    name = "renderer_system"

    def __init__(self, engine):
        super().__init__(engine)
        self.models = ModelRegistry()
        # heightmaps, read by the physics heightfields (the render terrain
        # component is not ported)
        self.terrains = TerrainRegistry()
        self._baked = False
        # particle script sources: name -> (src, imports dict)
        self.particle_scripts: Dict[str, tuple] = {}
        # render plugins, called by draw_stream.record_frame
        self.plugins: list = []

    def add_plugin(self, plugin) -> None:
        self.plugins.append(plugin)

    def add_model(self, model: Model) -> int:
        self._baked = False
        return self.models.add(model)

    def bake(self) -> ModelRegistry:
        if not self._baked:
            self.models.bake()
            self._baked = True
        return self.models

    def add_particle_script(self, name: str, src: str, imports=None):
        """Register a .pat particle script (with its imported .pai sources)."""
        self.particle_scripts[name] = (src, imports or {})

    def particle_system(self, script: str):
        from lumixengine_tpu_torch.renderer.particle_system import ParticleSystem

        src, imports = self.particle_scripts[script]
        return ParticleSystem.from_source(src, imports=imports)

    def create_modules(self, world: World) -> RenderModule:
        caps = getattr(self.engine, "module_capacities", {})
        return RenderModule(
            world, self,
            max_model_instances=caps.get("model_instances", min(world.capacity, 4096)),
            max_cameras=caps.get("cameras", 4),
            max_point_lights=caps.get("point_lights", 256),
        )
