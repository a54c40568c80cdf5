"""The render pipeline (counterpart of ``lumixengine_tpu/renderer/pipeline.py``):
camera frustum, sphere cull of the model instances (kernel K1), LOD pick by
camera distance, point-light cull and the counters for camera 0 of every
world in the batch (``cull_pass``); and the render consumer's view
(``prepare_view``): the same cull, 64-bit sort keys, the draw order and the
instance buffers in draw order, with the instanced-model chunks culled as
one sphere each.

The reference's keys are uint32 (hi, lo) word pairs. torch's uint32 is a
storage type with few kernels, so the port carries each word in int64,
where every op it needs is defined; the two stable argsorts are the
reference's (lo word first, then hi word)."""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from lumixengine_tpu_torch.core import geometry as geom
from lumixengine_tpu_torch.engine.world import WorldState
from lumixengine_tpu_torch.ops import culling as cullops
from lumixengine_tpu_torch.renderer.model import MAX_LODS

SORT_DEPTH = 0     # back-to-front depth bucket (transparent)
SORT_MATERIAL = 1  # material/state bucket (opaque)
INVISIBLE_KEY = 0xFFFFFFFF  # both key words of a culled instance: it sorts to the tail
DEPTH_EPS = 1e-3   # 1/64 m: a depth key this close to an integer may round apart


@dataclass
class View:
    """Draw-ready view data of camera `cam_slot` in every world of the batch."""

    visible: torch.Tensor          # bool [.., K]
    lod: torch.Tensor              # int32 [.., K]
    sort_key: torch.Tensor         # int64 [.., K] hi word (bucket), a uint32 value
    sort_key_lo: torch.Tensor      # int64 [.., K] lo word (within-bucket order)
    order: torch.Tensor            # int32 [.., K] draw order (invisible at the tail)
    instance_pos: torch.Tensor     # f32 [.., 3, K] world positions in draw order
    instance_rot: torch.Tensor     # f32 [.., 4, K]
    instance_scale: torch.Tensor   # f32 [.., 3, K]
    instance_model: torch.Tensor   # int32 [.., K] model id in draw order (-1 culled)
    instance_slot: torch.Tensor    # int32 [.., K] entity world slot in draw order
    visible_count: torch.Tensor    # int32 [..]
    lights_visible: torch.Tensor   # bool [.., L]
    instanced_visible: torch.Tensor  # bool [.., IM] per instanced-model chunk


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
        # instanced-model chunks: one bounding sphere per component over its
        # instance blob, in the owner entity's space
        im_slots, im_models, im_centers, im_radii = [], [], [], []
        for e, im in module.instanced_models.items():
            pos = im["pos"]
            if len(pos) == 0:
                continue
            center = pos.mean(axis=0)
            mdl_r = float(reg.host_bounding_radius[im["model"]])
            im_slots.append(w.slot(e))
            im_models.append(im["model"])
            im_centers.append(center)
            im_radii.append(float(np.linalg.norm(pos - center, axis=-1).max()) + mdl_r)
        self.im_slots = np.asarray(im_slots, np.int32)
        self.im_models = np.asarray(im_models, np.int32)
        self.im_centers = (np.asarray(im_centers, np.float32).T.copy()
                           if im_centers else np.zeros((3, 0), np.float32))
        self.im_radii = np.asarray(im_radii, np.float32)
        # bone attachments whose parent is animated (RenderModule.late_update)
        self.ba_flat, self.ba_slots, self.ba_offset_pos, self.ba_offset_rot = \
            module.attachment_wiring()
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
                mi_model=t(self.mi_model),
                material=t(self.material.astype(np.int64)),
                im_index=t(np.maximum(self.im_slots, 0).astype(np.int64)),
                im_centers=t(self.im_centers),
                im_radii=t(self.im_radii),
                ba_flat=t(self.ba_flat),
                ba_slots=t(self.ba_slots),
                ba_offset_pos=t(self.ba_offset_pos),
                ba_offset_rot=t(self.ba_offset_rot),
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
    return frustum, visible, lod, d2, ipos


def _gather_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[..., c, index[..., k]] per world: x [.., C, K], index [.., K]."""
    return torch.gather(x, -1, index.unsqueeze(-2).expand(x.shape[:-1] + index.shape[-1:]))


def prepare_view(ws: WorldState, module, cam_slot: int = 0, sort_mode: int = SORT_MATERIAL,
                 statics: Optional[ViewStatics] = None) -> View:
    """Cull (K1, one launch), LOD, sort keys, draw order and instance
    buffers of camera `cam_slot` in every world of `ws`."""
    statics = statics or module.statics()
    rs = ws.modules[module.name]
    d = statics.on(ws.world.pos.device)
    frustum, visible, lod, d2, ipos = _cull_and_lod(ws, rs, statics, cam_slot)

    # (hi, lo) key words as uint32 values in int64 (26.6 fixed-point depth)
    depth_q = (torch.sqrt(d2) * 64.0).to(torch.int64)
    if sort_mode == SORT_MATERIAL:
        # opaque: bucket by material|lod, front-to-back inside the bucket
        key = (d.material << 8) | lod.to(torch.int64)
        key_lo = depth_q
    else:
        # transparent: back-to-front depth major, material minor
        key = (0xFFFFFF00 - depth_q) & 0xFFFFFFFF
        key_lo = d.material.expand_as(depth_q)
    key = torch.where(visible, key, INVISIBLE_KEY)
    key_lo = torch.where(visible, key_lo, INVISIBLE_KEY)
    order_lo = torch.argsort(key_lo, dim=-1, stable=True)
    order = torch.gather(order_lo, -1, torch.argsort(torch.gather(key, -1, order_lo), dim=-1,
                                                     stable=True))

    irot = ws.world.rot.index_select(-1, d.mi_index)
    iscale = ws.world.scale.index_select(-1, d.mi_index)
    model_ids = torch.where(visible, d.mi_model, -1)
    return View(
        visible=visible, lod=lod, sort_key=key, sort_key_lo=key_lo,
        order=order.to(torch.int32),
        instance_pos=_gather_last(ipos, order),
        instance_rot=_gather_last(irot, order),
        instance_scale=_gather_last(iscale, order),
        instance_model=torch.gather(model_ids, -1, order),
        instance_slot=d.mi_index[order].to(torch.int32),
        visible_count=torch.sum(visible, dim=-1).to(torch.int32),
        lights_visible=_cull_lights(ws, rs, statics, frustum),
        instanced_visible=_cull_instanced(ws, statics, frustum),
    )


def _cull_instanced(ws: WorldState, statics: ViewStatics, frustum: geom.Frustum) -> torch.Tensor:
    """Chunk-sphere culling of the instanced-model components (each
    instance blob is one sphere in its owner entity's space)."""
    d = statics.on(ws.world.pos.device)
    if statics.im_slots.size == 0:
        return torch.zeros(ws.alive.shape[:-1] + (0,), dtype=torch.bool, device=d.im_index.device)
    centers = ws.world.pos.index_select(-1, d.im_index) + d.im_centers
    return geom.frustum_sphere_visible(frustum, centers, d.im_radii)


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
    frustum, visible, lod, _d2, _ipos = _cull_and_lod(ws, rs, statics, 0)
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


def depth_margins(ws: WorldState, module) -> torch.Tensor:
    """How far each instance's 26.6 fixed-point depth key on camera 0 (64 ·
    its distance to the camera, in float64) sits from an integer [.., K].
    Two float32 implementations may round the key apart only where it is
    under DEPTH_EPS."""
    statics = module.statics()
    _f, ipos, _r = cull_operands(ws, ws.modules[module.name], statics, 0)
    cam = ws.world.pos[..., :, max(int(statics.cam_slots[0]), 0)]
    q = 64.0 * torch.linalg.vector_norm((ipos - cam[..., None]).double(), dim=-2)
    return (q - q.round()).abs()


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
