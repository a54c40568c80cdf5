"""Headless scene viewer (counterpart of ``lumixengine_tpu/renderer/viewer.py``):
the prepared View of the runner's state as a self-contained SVG —
perspective-projected circles sized by bounding radius, far to near,
coloured by model id, the alive particles as dots and the GUI overlay on
top.
"""
from __future__ import annotations

from typing import List

import numpy as np

from lumixengine_tpu_torch.core import host_math as hm

_PALETTE = ["#4e79a7", "#f28e2b", "#59a14f", "#e15759", "#b07aa1",
            "#76b7b2", "#edc948", "#ff9da7", "#9c755f", "#bab0ac"]


def _project(points, cam_pos, cam_rot, fov_y, aspect, width, height):
    """World [N, 3] → screen [N, 2] and depth [N] (the camera looks down -Z)."""
    inv_rot = hm.quat_conjugate(cam_rot)
    local = hm.quat_rotate(np.broadcast_to(inv_rot, (len(points), 4)), points - cam_pos)
    depth = -local[:, 2]
    f = 1.0 / np.tan(fov_y * 0.5)
    safe = np.maximum(depth, 1e-3)
    x = (local[:, 0] * f / aspect) / safe
    y = (local[:, 1] * f) / safe
    return np.stack([(x * 0.5 + 0.5) * width, (1.0 - (y * 0.5 + 0.5)) * height], -1), depth


def render_svg(runner, path: str, cam_slot: int = 0, width: int = 960, height: int = 540) -> str:
    """Write the runner's current state as an SVG file; returns the path."""
    from lumixengine_tpu_torch.renderer.raster import camera_of

    world, state = runner.world, runner.state
    rmod = world.modules["renderer"]
    cam_slot, cam_pos, cam_rot, fov = camera_of(runner, cam_slot)
    view = runner.prepare_view(cam_slot)
    aspect = width / height
    n_vis = int(view.visible_count)
    pos = view.instance_pos.cpu().numpy().T[:n_vis]
    models = view.instance_model.cpu().numpy()[:n_vis]
    scales = view.instance_scale.cpu().numpy().T[:n_vis]
    parts: List[str] = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
        f'viewBox="0 0 {width} {height}">',
        f'<rect width="{width}" height="{height}" fill="#101418"/>',
    ]
    if n_vis:
        xy, depth = _project(pos, cam_pos, cam_rot, fov, aspect, width, height)
        radii = rmod.system.bake().host_bounding_radius[np.maximum(models, 0)]
        radii = radii * np.max(np.abs(scales), axis=-1)
        f = 1.0 / np.tan(fov * 0.5)
        px_r = np.clip(radii * f / np.maximum(depth, 1e-3) * height * 0.5, 0.7, 200)
        for i in np.argsort(-depth):      # far → near
            if depth[i] <= 0:
                continue
            c = _PALETTE[int(models[i]) % len(_PALETTE)]
            parts.append(f'<circle cx="{xy[i,0]:.1f}" cy="{xy[i,1]:.1f}" r="{px_r[i]:.1f}" '
                         f'fill="{c}" fill-opacity="0.8"/>')
    rs = state.modules["renderer"]
    for _key, sub in rs.particles.items():
        for _name, est in sub.items():
            alive = est.alive.cpu().numpy()
            if est.outs.shape[0] < 3 or not alive.any():
                continue
            ppos = est.outs[0:3].cpu().numpy().T[alive]
            xy, depth = _project(ppos, cam_pos, cam_rot, fov, aspect, width, height)
            for (x, y), d in zip(xy[:2000], depth[:2000]):
                if d > 0:
                    parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="1" fill="#ffd080"/>')
    gm = world.modules.get("gui")
    if gm is not None and "gui" in state.modules:
        for item in gm.draw_list(state):
            x0, y0, x1, y1 = item["rect"]
            sx, sy = width / gm.canvas_size[0], height / gm.canvas_size[1]
            col = item.get("color", [1, 1, 1, 0.3])
            rgb = f"rgb({int(col[0]*255)},{int(col[1]*255)},{int(col[2]*255)})"
            parts.append(f'<rect x="{x0*sx:.1f}" y="{y0*sy:.1f}" width="{(x1-x0)*sx:.1f}" '
                         f'height="{(y1-y0)*sy:.1f}" fill="{rgb}" '
                         f'fill-opacity="{col[3]*0.5:.2f}" stroke="{rgb}"/>')
            if "text" in item:
                parts.append(f'<text x="{(x0+4)*sx:.1f}" y="{(y0+16)*sy:.1f}" fill="white" '
                             f'font-size="{item.get("font_size", 14)}">{item["text"]}</text>')
    m = runner.metrics()
    hud = f'frame {m.get("frame")}  visible {int(m.get("renderer.visible_count", 0))}'
    parts.append(f'<text x="8" y="18" fill="#8f8" font-family="monospace" '
                 f'font-size="13">{hud}</text>')
    parts.append("</svg>")
    with open(path, "w") as f_out:
        f_out.write("\n".join(parts))
    return path
