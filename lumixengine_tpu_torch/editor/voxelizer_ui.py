"""Voxelizer editor (counterpart of ``lumixengine_tpu/editor/voxelizer_ui.py``;
≙ reference renderer/editor/voxelizer_ui.cpp:1-204 —
a dev window that voxelizes a model, computes/blurs the AO field, and draws
the grid as colored cubes in the viewport).

Same surface, terminal-grade: a model loads through the real FBX importer,
`voxelize_triangles` (renderer/voxels.py) builds the occupancy grid,
`occupancy_ao` + box-blur produce the AO field, and the visualization is a
scrollable horizontal SLICE of the grid rendered as ANSI half-blocks —
occupied cells shade by AO × multiplier exactly like visualizeAO()'s
`ao[v] * m_ao_multiplier * 255` grey cubes (voxelizer_ui.cpp:77-80).

Keys: v voxelize · a AO view (computes on first use) · b blur AO ·
[ / ] move slice · r cycle resolution 16/32/64 · +/- AO multiplier."""
from __future__ import annotations

from typing import Optional

import numpy as np

_RESOLUTIONS = [16, 32, 64]


class VoxelizerUI:
    def __init__(self, model_path: Optional[str] = None,
                 vertices: Optional[np.ndarray] = None,
                 indices: Optional[np.ndarray] = None):
        self.model_path = model_path
        if model_path is not None:
            from lumixengine_tpu_torch.importers.fbx import load_fbx, to_model

            model = to_model(load_fbx(model_path), name=model_path)
            vertices = model.vertex_positions
            indices = model.vertex_triangles
        self.vertices = np.asarray(vertices, np.float32)
        self.indices = (None if indices is None
                        else np.asarray(indices, np.int32))
        self.resolution = 32
        self.ao_dist = 4            # ≙ ray_count: AO gather radius
        self.ao_multiplier = 1.0
        self.show_ao = False
        self.slice_idx = 0
        self.grid = None            # bool [R,R,R]
        self.ao = None              # f32 [R,R,R]
        self.status = "voxelizer — v voxelizes"
        self.voxelize()

    # -- bake --------------------------------------------------------------

    def voxelize(self) -> None:
        from lumixengine_tpu_torch.renderer.voxels import (voxelize_points,
                                                     voxelize_triangles)

        if self.indices is not None and len(self.indices):
            self.grid, self.mins, self.cell = voxelize_triangles(
                self.vertices, self.indices, self.resolution)
        else:
            self.grid, self.mins, self.cell = voxelize_points(
                self.vertices, self.resolution)
        self.ao = None              # stale after re-voxelize
        self.slice_idx = min(self.slice_idx, self.resolution - 1)
        n = int(self.grid.sum())
        self.status = (f"voxelized {len(self.vertices)} verts → "
                       f"{n} cells at {self.resolution}³")

    def compute_ao(self) -> None:
        from lumixengine_tpu_torch.renderer.voxels import occupancy_ao

        self.ao = occupancy_ao(self.grid, max_dist=self.ao_dist)
        self.status = f"AO computed (dist {self.ao_dist})"

    def blur_ao(self) -> None:
        """3³ box blur (≙ VoxelizerModule::blurAO)."""
        if self.ao is None:
            self.compute_ao()
        a = self.ao
        acc = np.zeros_like(a)
        cnt = np.zeros_like(a)
        r = a.shape[0]
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    sx = slice(max(dx, 0), r + min(dx, 0))
                    tx = slice(max(-dx, 0), r + min(-dx, 0))
                    sy = slice(max(dy, 0), r + min(dy, 0))
                    ty = slice(max(-dy, 0), r + min(-dy, 0))
                    sz = slice(max(dz, 0), r + min(dz, 0))
                    tz = slice(max(-dz, 0), r + min(-dz, 0))
                    acc[tx, ty, tz] += a[sx, sy, sz]
                    cnt[tx, ty, tz] += 1.0
        self.ao = acc / cnt
        self.status = "AO blurred"

    # -- visualize ------------------------------------------------------------

    def slice_image(self) -> np.ndarray:
        """uint8 [R,R,3] image of the current horizontal (y) slice:
        occupied cells white, or AO-shaded grey in AO view."""
        y = int(np.clip(self.slice_idx, 0, self.resolution - 1))
        occ = self.grid[:, y, :]                       # [x, z]
        img = np.zeros((self.resolution, self.resolution, 3), np.uint8)
        if self.show_ao:
            if self.ao is None:
                self.compute_ao()
            g = np.clip((1.0 - self.ao[:, y, :] * self.ao_multiplier)
                        * 255.0, 0.0, 255.0).astype(np.uint8)
            img[occ] = np.stack([g[occ]] * 3, axis=-1)
        else:
            img[occ] = 255
        return np.transpose(img, (1, 0, 2))            # rows = z, cols = x

    # -- keys --------------------------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        ch = text.lower()
        if ch == "v":
            self.voxelize()
        elif ch == "a":
            self.show_ao = not self.show_ao
            if self.show_ao and self.ao is None:
                self.compute_ao()
            self.status = f"AO view {'on' if self.show_ao else 'off'}"
        elif ch == "b":
            self.blur_ao()
        elif ch == "[":
            self.slice_idx = max(self.slice_idx - 1, 0)
            self.status = f"slice y={self.slice_idx}"
        elif ch == "]":
            self.slice_idx = min(self.slice_idx + 1, self.resolution - 1)
            self.status = f"slice y={self.slice_idx}"
        elif ch == "r":
            i = _RESOLUTIONS.index(self.resolution) \
                if self.resolution in _RESOLUTIONS else 0
            self.resolution = _RESOLUTIONS[(i + 1) % len(_RESOLUTIONS)]
            self.voxelize()                 # ≙ resolution edit clears voxels
        elif ch == "+":
            self.ao_multiplier = min(self.ao_multiplier * 1.25, 32.0)
            self.status = f"AO multiplier {self.ao_multiplier:.2f}"
        elif ch == "-":
            self.ao_multiplier = max(self.ao_multiplier / 1.25, 0.05)
            self.status = f"AO multiplier {self.ao_multiplier:.2f}"

    def render_text(self, width: int = 100, height: int = 28) -> str:
        from lumixengine_tpu_torch.core.os_terminal import TerminalWindowBackend

        img = self.slice_image()
        # scale the R×R slice up/down to the pane (nearest)
        img_h = max((height - 2) * 2, 2)
        w = max(width, 2)
        ys = (np.arange(img_h) * img.shape[0] // img_h).clip(
            0, img.shape[0] - 1)
        xs = (np.arange(w) * img.shape[1] // w).clip(0, img.shape[1] - 1)
        ansi = TerminalWindowBackend.ansi_image(img[ys][:, xs])
        name = self.model_path or f"{len(self.vertices)} verts"
        head = (f"voxelizer — {name} {self.resolution}³ slice "
                f"y={self.slice_idx} "
                f"{'AO' if self.show_ao else 'occupancy'} "
                f"x{self.ao_multiplier:.2f}")
        foot = (f"[{self.status}]  keys: v voxelize · a AO · b blur · "
                "[/] slice · r res · +/- mult")
        return "\n".join([head.ljust(width)[:width], ansi,
                          foot.ljust(width)[:width]])
