"""Materials, shaders and textures: the data layer (counterpart of
``lumixengine_tpu/renderer/material.py``).

A material is a shader name, uniform values, textures by slot, a render
layer and a define set. The uniform blocks bake into a bank of tensors
[M, U] on a device, gathered per draw batch; textures stay host arrays
that the bake-time samplers (``raster.model_triangle_colors``) read.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch


@dataclass
class Shader:
    """A named program with its declared uniforms, defines and surfaces."""

    name: str
    uniforms: List[str] = field(default_factory=list)
    defines: List[str] = field(default_factory=list)
    surfaces: List[str] = field(default_factory=list)


@dataclass
class Texture:
    name: str
    data: np.ndarray          # [H, W, C] u8 or f32
    srgb: bool = True
    wrap: str = "repeat"

    def sample_host(self, u: float, v: float):
        h, w = self.data.shape[:2]
        x = int(np.clip(u * w, 0, w - 1))
        y = int(np.clip(v * h, 0, h - 1))
        return self.data[y, x]


@dataclass
class Material:
    name: str
    shader: str = "standard"
    layer: str = "default"
    uniforms: Dict[str, float] = field(default_factory=dict)
    textures: Dict[str, str] = field(default_factory=dict)
    defines: List[str] = field(default_factory=list)
    alpha_blend: bool = False


@dataclass
class MaterialBank:
    """The uniform blocks on one device."""

    uniforms: torch.Tensor    # f32 [M, U]
    layer_id: torch.Tensor    # int32 [M]
    alpha: torch.Tensor       # bool [M]


UNIFORM_SLOTS = ["roughness", "metallic", "emission", "alpha_ref",
                 "color_r", "color_g", "color_b", "color_a"]


class MaterialRegistry:
    def __init__(self):
        self.shaders: Dict[str, Shader] = {
            "standard": Shader("standard", uniforms=list(UNIFORM_SLOTS), surfaces=["default"]),
        }
        self.textures: Dict[str, Texture] = {}
        self.materials: List[Material] = [Material("default")]
        self._by_name: Dict[str, int] = {"default": 0}
        self.layers: List[str] = ["default", "transparent", "decal", "ui"]
        self._banks: Dict[str, MaterialBank] = {}

    def add_shader(self, shader: Shader) -> None:
        self.shaders[shader.name] = shader

    def add_texture(self, tex: Texture) -> None:
        self.textures[tex.name] = tex

    def add(self, mat: Material) -> int:
        if mat.shader not in self.shaders:
            raise KeyError(f"unknown shader {mat.shader!r}")
        mid = len(self.materials)
        self.materials.append(mat)
        self._by_name[mat.name] = mid
        self._banks = {}
        return mid

    def get_id(self, name: str) -> int:
        return self._by_name[name]

    def get(self, mid: int) -> Material:
        return self.materials[mid]

    def layer_id(self, name: str) -> int:
        if name not in self.layers:
            self.layers.append(name)
        return self.layers.index(name)

    def host_bank(self):
        """(uniforms f32 [M, U], layer ids int32 [M], alpha bool [M]) on the host."""
        m = len(self.materials)
        u = np.zeros((m, len(UNIFORM_SLOTS)), np.float32)
        u[:, UNIFORM_SLOTS.index("roughness")] = 0.8
        u[:, 4:8] = 1.0
        layer = np.zeros(m, np.int32)
        alpha = np.zeros(m, bool)
        for i, mat in enumerate(self.materials):
            for k, v in mat.uniforms.items():
                if k in UNIFORM_SLOTS:
                    u[i, UNIFORM_SLOTS.index(k)] = v
            layer[i] = self.layer_id(mat.layer)
            alpha[i] = mat.alpha_blend
        return u, layer, alpha

    def bank(self, device) -> MaterialBank:
        """The uniform blocks on `device`, built once a device (a material
        added later rebuilds it)."""
        key = str(torch.device(device))
        if key not in self._banks:
            self._banks[key] = MaterialBank(*(torch.as_tensor(a, device=device)
                                              for a in self.host_bank()))
        return self._banks[key]
