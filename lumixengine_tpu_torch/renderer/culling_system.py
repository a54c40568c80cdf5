"""CullingSystem (counterpart of ``lumixengine_tpu/renderer/culling_system.py``):
one fixed-capacity store of (entity, radius); the test itself is kernel K1
in ``ops/culling.py``, run by the pipeline's cull pass."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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

    def device_state(self, device, world=None) -> CullingState:
        d = self.store.device(device, world)
        return CullingState(entity=d["entity"], radius=d["radius"])
