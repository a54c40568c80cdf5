"""Model resources (counterpart of ``lumixengine_tpu/renderer/model.py``), as
far as the cull pass, the animation and physics need them: a bounding
radius, up to 4 LOD switch distances, a material id, an optional skeleton
and optional mesh data per model: vertex positions (the point cloud an
instanced_mesh cooks its hull from), UVs, triangles and skin weights (the
presents draw them).
``ModelRegistry.bake`` fills the host mirrors the view statics read and the
bank's bone count."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from lumixengine_tpu_torch.core import host_math as hm

MAX_LODS = 4


@dataclass
class Skeleton:
    """Host skeleton; parents must come before their children."""

    bone_parent: np.ndarray  # int32 [B], -1 root
    bind_pos: np.ndarray     # f32 [B,3] local bind translation
    bind_rot: np.ndarray     # f32 [B,4] local bind rotation
    bone_names: List[str] = field(default_factory=list)

    def __post_init__(self):
        self.bone_parent = np.asarray(self.bone_parent, np.int32)
        self.bind_pos = np.asarray(self.bind_pos, np.float32)
        self.bind_rot = np.asarray(self.bind_rot, np.float32)
        if np.any(self.bone_parent >= np.arange(len(self.bone_parent))):
            raise ValueError("skeleton bones must be topologically sorted (parent < child)")

    @property
    def bone_count(self) -> int:
        return int(self.bone_parent.shape[0])

    def absolute_bind(self):
        """Model-space bind pose (host): compose down the chains."""
        b = self.bone_count
        abs_pos = np.zeros((b, 3), np.float32)
        abs_rot = np.zeros((b, 4), np.float32)
        for i in range(b):
            p = int(self.bone_parent[i])
            if p < 0:
                abs_pos[i], abs_rot[i] = self.bind_pos[i], self.bind_rot[i]
            else:
                one = np.ones(3, np.float32)
                abs_pos[i], abs_rot[i], _ = hm.compose(
                    abs_pos[p], abs_rot[p], one, self.bind_pos[i], self.bind_rot[i], one)
        return abs_pos, abs_rot

    def inverse_bind(self):
        """Inverse of the model-space bind pose (rigid), for skinning palettes."""
        abs_pos, abs_rot = self.absolute_bind()
        inv_rot = hm.quat_conjugate(abs_rot)
        inv_pos = hm.quat_rotate(inv_rot, -abs_pos)
        return inv_pos, inv_rot


@dataclass
class Model:
    name: str
    bounding_radius: float = 1.0
    lod_distances: Optional[np.ndarray] = None  # f32 [4], inf = unused
    skeleton: Optional[Skeleton] = None
    vertex_positions: Optional[np.ndarray] = None  # f32 [V,3]
    material_id: int = 0
    vertex_uvs: Optional[np.ndarray] = None        # f32 [V,2] (bake-time texture sampling)
    vertex_triangles: Optional[np.ndarray] = None  # int32 [T,3] (the presents' meshes)
    vertex_weights: Optional[np.ndarray] = None    # f32 [V,4] skin weights
    vertex_bones4: Optional[np.ndarray] = None     # int32 [V,4] skin bone ids
    vertex_bone: Optional[np.ndarray] = None       # int32 [V] dominant bone (the FBX importer's)
    mesh_id: int = 0

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
        self.max_bones = 1

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

    def bake(self, min_bones: int = 1) -> None:
        """Fill host_bounding_radius [M], host_lod_dist2 [4, M] (squared
        switch distances), host_material_id [M] and max_bones (the largest
        skeleton, at least `min_bones`)."""
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
        self.max_bones = max([min_bones] + [mo.skeleton.bone_count for mo in self.models
                                            if mo.skeleton])


def make_humanoid_skeleton(num_bones: int = 32, seed: int = 0) -> Skeleton:
    """Procedural test skeleton: chains off a root, each bone attached to one
    of the 4 bones before it; the reference's numpy draws in its order."""
    rng = np.random.default_rng(seed)
    parent = np.full(num_bones, -1, np.int32)
    pos = np.zeros((num_bones, 3), np.float32)
    rot = np.tile(hm.QUAT_IDENTITY, (num_bones, 1))
    for i in range(1, num_bones):
        lo = max(0, i - 4)
        parent[i] = rng.integers(lo, i)
        pos[i] = rng.normal(0, 0.15, 3).astype(np.float32) + np.array([0, 0.25, 0], np.float32)
        axis = rng.normal(size=3).astype(np.float32)
        axis /= np.linalg.norm(axis)
        rot[i] = hm.quat_from_axis_angle(axis, rng.uniform(-0.3, 0.3))
    return Skeleton(bone_parent=parent, bind_pos=pos, bind_rot=rot,
                    bone_names=[f"bone{i}" for i in range(num_bones)])
