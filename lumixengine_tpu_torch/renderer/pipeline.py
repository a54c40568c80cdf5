"""The render pipeline's cull pass (counterpart of
``lumixengine_tpu/renderer/pipeline.py``): camera frustum, sphere cull of the
model instances (kernel K1), LOD pick by camera distance, point-light cull
and the counters, for camera 0 of every world in the batch."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from lumixengine_tpu_torch.core import geometry as geom
from lumixengine_tpu_torch.engine.world import WorldState
from lumixengine_tpu_torch.ops import culling as cullops
from lumixengine_tpu_torch.renderer.model import MAX_LODS


class ViewStatics:
    """Static render membership of one world: slot indices, model ids, cull
    radii and masks (host numpy), plus their tensors per device (``on``)."""

    def __init__(self, module):
        w = module.world
        reg = module.system.bake()
        self.mi_slots = w.to_slots(module.model_instances.entity)       # [K]
        self.mi_mask = self.mi_slots >= 0
        self.mi_model = np.asarray(module.model_instances.data["model"], np.int32)
        self.radius = np.asarray(module.culling.store.data["radius"], np.float32)
        mid = np.maximum(self.mi_model, 0)
        self.lod_dist2 = reg.host_lod_dist2[:, mid]                     # [4,K]
        self.material = reg.host_material_id[mid]                       # [K]
        self.cam_slots = w.to_slots(module.cameras.entity)              # [C]
        self.cam_entities = np.asarray(module.cameras.entity, np.int64)
        self.pl_slots = w.to_slots(module.point_lights.entity)          # [L]
        self.pl_mask = self.pl_slots >= 0
        self._dev: Dict[str, SimpleNamespace] = {}

    def on(self, device) -> SimpleNamespace:
        """The index and mask tensors on `device`, built once."""
        key = str(torch.device(device))
        if key not in self._dev:
            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a), device=device)

            self._dev[key] = SimpleNamespace(
                mi_index=t(np.maximum(self.mi_slots, 0).astype(np.int64)),
                mi_mask=t(self.mi_mask),
                radius=t(self.radius),
                lod_dist2=t(self.lod_dist2),
                pl_index=t(np.maximum(self.pl_slots, 0).astype(np.int64)),
                pl_mask=t(self.pl_mask),
            )
        return self._dev[key]


def resolve_cam_slot(statics: ViewStatics, cam_slot: int) -> int:
    """A camera store slot, or a camera entity id mapped to its slot."""
    n = len(statics.cam_slots)
    if 0 <= cam_slot < n:
        return int(cam_slot)
    hits = np.nonzero(statics.cam_entities == cam_slot)[0]
    if hits.size:
        return int(hits[0])
    raise ValueError(f"cam_slot {cam_slot} is neither a camera slot (world has {n} cameras)"
                     f" nor a camera entity id (cameras: {statics.cam_entities.tolist()})")


def camera_frustum(ws: WorldState, rs, statics: ViewStatics, cam_slot: int) -> geom.Frustum:
    """The camera's frustum from its entity's world transform; both
    projections are built and selected per world by ``cam_is_ortho``."""
    cam_slot = resolve_cam_slot(statics, cam_slot)
    e = max(int(statics.cam_slots[cam_slot]), 0)
    pos = ws.world.pos[..., :, e]
    rot = ws.world.rot[..., :, e]
    aspect = rs.cam_aspect[..., cam_slot]
    near = rs.cam_near[..., cam_slot]
    far = rs.cam_far[..., cam_slot]
    persp = geom.perspective_frustum(pos, rot, rs.cam_fov[..., cam_slot], aspect, near, far)
    oh = rs.cam_ortho_size[..., cam_slot]
    ortho = geom.ortho_frustum(pos, rot, 2.0 * oh * aspect, 2.0 * oh, near, far)
    is_o = rs.cam_is_ortho[..., cam_slot].unsqueeze(-1)
    return geom.Frustum(
        xs=torch.where(is_o, ortho.xs, persp.xs),
        ys=torch.where(is_o, ortho.ys, persp.ys),
        zs=torch.where(is_o, ortho.zs, persp.zs),
        ds=torch.where(is_o, ortho.ds, persp.ds),
    )


def select_lod(dist2: torch.Tensor, lod_dist2: torch.Tensor) -> torch.Tensor:
    """LOD index = number of switch distances passed. dist2 [..., K],
    lod_dist2 [4, K] → int32 [..., K]."""
    return torch.sum(dist2[..., None, :] > lod_dist2, dim=-2).to(torch.int32)


def cull_operands(ws: WorldState, rs, statics: ViewStatics, cam_slot: int = 0):
    """The sphere test's operands for the model instances, as the cull pass
    gives them to K1: (frustum, centers [..,3,K], radii [..,K])."""
    d = statics.on(ws.world.pos.device)
    frustum = camera_frustum(ws, rs, statics, cam_slot)
    ipos = ws.world.pos.index_select(-1, d.mi_index)
    iscale = ws.world.scale.index_select(-1, d.mi_index)
    radii = d.radius * torch.amax(torch.abs(iscale), dim=-2)
    return frustum, ipos, radii


def _cull_and_lod(ws: WorldState, rs, statics: ViewStatics, cam_slot: int):
    cam_slot = resolve_cam_slot(statics, cam_slot)
    d = statics.on(ws.world.pos.device)
    frustum, ipos, radii = cull_operands(ws, rs, statics, cam_slot)
    visible = cullops.frustum_cull(ipos, radii, frustum.planes)
    alive = ws.alive.index_select(-1, d.mi_index) & d.mi_mask
    visible = visible & alive

    cam_pos = ws.world.pos[..., :, max(int(statics.cam_slots[cam_slot]), 0)]
    d2 = torch.sum((ipos - cam_pos[..., None]) ** 2, dim=-2)
    lod = torch.clamp_max(select_lod(d2, d.lod_dist2), MAX_LODS - 1)
    return frustum, visible, lod


def _cull_lights(ws: WorldState, rs, statics: ViewStatics, frustum: geom.Frustum) -> torch.Tensor:
    d = statics.on(ws.world.pos.device)
    centers = ws.world.pos.index_select(-1, d.pl_index)
    vis = geom.frustum_sphere_visible(frustum, centers, rs.pl_range)
    return vis & d.pl_mask


def cull_pass(ws: WorldState, dt, module, statics: Optional[ViewStatics] = None) -> WorldState:
    """Visibility + LOD + light culling + counters for camera 0, stored back
    into the RenderState."""
    statics = statics or module.statics()
    rs = ws.modules[module.name]
    frustum, visible, lod = _cull_and_lod(ws, rs, statics, 0)
    lights = _cull_lights(ws, rs, statics, frustum)
    rs = rs.replace(
        mi_visible=visible,
        mi_lod=lod,
        pl_visible=lights,
        counters={**rs.counters,
                  "visible_count": torch.sum(visible, dim=-1).to(torch.int32),
                  "lights_visible": torch.sum(lights, dim=-1).to(torch.int32)},
    )
    return ws.replace(modules={**ws.modules, module.name: rs})


def cull_margins(ws: WorldState, module):
    """How far each decision of the cull pass on camera 0 sits from its
    threshold, in float64: (model instances [.., K], LOD switches [.., K]
    in distance units, point lights [.., L]). Two float32 implementations
    may disagree only where a margin is near 0."""
    statics = module.statics()
    d = statics.on(ws.world.pos.device)
    rs = ws.modules[module.name]
    frustum, ipos, radii = cull_operands(ws, rs, statics, 0)
    planes = frustum.planes.double()[..., :6, :]

    def sphere_margin(centers, r):
        dist = planes[..., :3] @ centers.double() + planes[..., 3:]
        return dist.amin(dim=-2) + r.double()

    cam = ws.world.pos[..., :, max(int(statics.cam_slots[0]), 0)]
    dist = torch.linalg.vector_norm((ipos - cam[..., None]).double(), dim=-2)
    lod = torch.sqrt(d.lod_dist2.double())
    lod_m = (dist[..., None, :] - lod).abs().nan_to_num(posinf=1e30).amin(dim=-2)
    lights = sphere_margin(ws.world.pos.index_select(-1, d.pl_index), rs.pl_range)
    return sphere_margin(ipos, radii), lod_m, lights
