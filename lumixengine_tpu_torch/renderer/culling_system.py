"""CullingSystem (counterpart of ``lumixengine_tpu/renderer/culling_system.py``):
one fixed-capacity store of (entity, radius), and ``cull``, whose sphere
test is kernel K1 in ``ops/culling.py`` (the pipeline's cull pass runs the
same test on its own gather)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lumixengine_tpu_torch.core.geometry import Frustum
from lumixengine_tpu_torch.ops.culling import frustum_cull
from lumixengine_tpu_torch.ops.physics_ops import take_vecs
from lumixengine_tpu_torch.utils.store import DenseStore


@dataclass
class CullingState:
    entity: torch.Tensor  # int32 [K], -1 empty
    radius: torch.Tensor  # f32 [K]


class CullingSystem:
    def __init__(self, capacity: int):
        self.store = DenseStore(capacity, {"radius": ((), np.float32, 1.0)})

    def add(self, entity: int, radius: float) -> None:
        self.store.add(entity, radius=np.float32(radius))

    def remove(self, entity: int) -> None:
        self.store.remove(entity)

    def is_added(self, entity: int) -> bool:
        return entity in self.store

    def set_radius(self, entity: int, radius: float) -> None:
        self.store.set(entity, "radius", np.float32(radius))

    def device_state(self, device, world=None) -> CullingState:
        d = self.store.device(device, world)
        return CullingState(entity=d["entity"], radius=d["radius"])


def cull(cs: CullingState, world_pos: torch.Tensor, world_scale: torch.Tensor,
         planes) -> torch.Tensor:
    """→ visible bool [..., K]: each stored sphere, its radius scaled by its
    entity's largest absolute world scale, against the frustum planes
    ([..., 8, 4], or a Frustum); empty store slots are not visible.
    world_pos / world_scale [..., 3, N] are indexed by the store's entity
    column as the device state holds it. The test is K1 on a CUDA device
    and its plain version on the CPU: the tensors' device decides, as
    everywhere in the port (the reference's `use_pallas` has no
    counterpart)."""
    if isinstance(planes, Frustum):
        planes = planes.planes
    eidx = torch.clamp_min(cs.entity, 0).to(torch.int64)
    centers = take_vecs(world_pos, eidx)
    max_scale = torch.amax(torch.abs(take_vecs(world_scale, eidx)), dim=-2)
    radii = cs.radius * max_scale
    batch = radii.shape[:-1]
    vis = frustum_cull(centers.expand(batch + centers.shape[-2:]), radii,
                       planes.expand(batch + planes.shape[-2:]))
    return vis & (cs.entity >= 0)
