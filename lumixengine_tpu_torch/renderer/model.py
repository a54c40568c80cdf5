"""Model resources (counterpart of ``lumixengine_tpu/renderer/model.py``), as
far as the cull pass needs them: a bounding radius, up to 4 LOD switch
distances and a material id per model. ``ModelRegistry.bake`` fills the host
mirrors the view statics read. Skeletons are outside the ported slice."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

MAX_LODS = 4


@dataclass
class Model:
    name: str
    bounding_radius: float = 1.0
    lod_distances: Optional[np.ndarray] = None  # f32 [4], inf = unused
    material_id: int = 0

    def __post_init__(self):
        if self.lod_distances is None:
            self.lod_distances = np.full(MAX_LODS, np.inf, np.float32)


class ModelRegistry:
    """Model name → id, and the host mirrors of the baked bank."""

    def __init__(self):
        self.models: List[Model] = []
        self._by_name: Dict[str, int] = {}
        self.host_bounding_radius = np.ones(1, np.float32)
        self.host_lod_dist2 = np.full((MAX_LODS, 1), np.inf, np.float32)
        self.host_material_id = np.zeros(1, np.int32)

    def add(self, model: Model) -> int:
        if model.name in self._by_name:
            raise ValueError(f"duplicate model {model.name!r}")
        mid = len(self.models)
        self.models.append(model)
        self._by_name[model.name] = mid
        return mid

    def get_id(self, name: str) -> int:
        return self._by_name[name]

    def get(self, mid: int) -> Model:
        return self.models[mid]

    def __len__(self):
        return len(self.models)

    def bake(self) -> None:
        """Fill host_bounding_radius [M], host_lod_dist2 [4, M] (squared
        switch distances) and host_material_id [M]."""
        m = max(1, len(self.models))
        radius = np.ones(m, np.float32)
        lod2 = np.full((m, MAX_LODS), np.inf, np.float32)
        mat = np.zeros(m, np.int32)
        for i, mo in enumerate(self.models):
            radius[i] = mo.bounding_radius
            ld = np.asarray(mo.lod_distances, np.float32)
            lod2[i] = np.where(np.isinf(ld), np.inf, ld * ld)
            mat[i] = mo.material_id
        self.host_bounding_radius = radius
        self.host_lod_dist2 = lod2.T.copy()
        self.host_material_id = mat
