"""The host triangle rasterizer (counterpart of
``lumixengine_tpu/renderer/raster.py``): the software present draws the
culled View's meshes with it, and its colour rules are the device
present's (``gpu_tpu.bake_soup``).

Every visible instance draws its mesh (``Model.vertex_positions`` and
``vertex_triangles``); a model without triangles draws a unit octahedron
scaled to 0.7 of its bounding radius. Projection and flat Lambert shading
(|n·L|, both faces lit) are numpy; the per-triangle fill runs in
``csrc/soft_raster.cpp`` through ``utils/native.py`` (the numpy loop below
gives the same pixels when the library cannot be built). It is a host
library, not the device path.
"""
from __future__ import annotations

import numpy as np

from lumixengine_tpu_torch.core import host_math as hm

# base palette by model id
_PALETTE = np.array([
    [78, 121, 167], [242, 142, 43], [89, 161, 79], [225, 87, 89],
    [176, 122, 161], [118, 183, 178], [237, 201, 72], [255, 157, 167],
    [156, 117, 95], [186, 176, 172]], np.float32)

_OCTA_V = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                    [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)
_OCTA_T = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                    [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)

_LIGHT = np.array([0.45, 0.8, 0.35], np.float32)
_LIGHT /= np.linalg.norm(_LIGHT)


def model_base_color(mid, registry, materials=None):
    """Per-model albedo (0-255 [3]): the material's colour where it sets
    color_r/g/b, else the palette by model id."""
    base = _PALETTE[int(mid) % len(_PALETTE)]
    if materials is None or mid < 0:
        return base
    try:
        mat = materials.get(int(registry.get(int(mid)).material_id))
    except (IndexError, KeyError, AttributeError):
        return base
    if any(k in mat.uniforms for k in ("color_r", "color_g", "color_b")):
        return np.array([mat.uniforms.get("color_r", 1.0), mat.uniforms.get("color_g", 1.0),
                         mat.uniforms.get("color_b", 1.0)], np.float32) * 255.0
    return base


def model_triangle_colors(mid, registry, materials=None):
    """Per-triangle albedo [T, 3] 0-255: the model's base colour times its
    material's first texture sampled at each triangle's UV centroid
    (mip 0, nearest texel), baked once per topology so the device raster
    needs no texture gather."""
    verts, tris = _mesh_of(mid, registry)
    base = np.asarray(model_base_color(mid, registry, materials), np.float32)
    cols = np.tile(base, (len(tris), 1))
    if materials is None or mid < 0:
        return cols
    try:
        m = registry.get(int(mid))
        mat = materials.get(int(m.material_id))
    except (IndexError, KeyError, AttributeError):
        return cols
    uv = getattr(m, "vertex_uvs", None)
    tex_names = getattr(mat, "textures", None) or {}
    if uv is None or not tex_names or len(uv) < len(verts):
        return cols
    tex = None
    for slot in sorted(tex_names):
        tex = materials.textures.get(tex_names[slot])
        if tex is not None:
            break
    if tex is None or getattr(tex, "data", None) is None:
        return cols
    cuv = np.asarray(uv, np.float32)[tris].mean(axis=1)     # [T, 2]
    data = np.asarray(tex.data)
    h, w = data.shape[:2]
    if getattr(tex, "wrap", "repeat") == "clamp":
        x = np.clip((cuv[:, 0] * w).astype(np.int64), 0, w - 1)
        y = np.clip((cuv[:, 1] * h).astype(np.int64), 0, h - 1)
    else:
        x = np.floor(cuv[:, 0] * w).astype(np.int64) % w
        y = np.floor(cuv[:, 1] * h).astype(np.int64) % h
    texel = data[y, x]
    if texel.ndim == 1:
        texel = texel[:, None]
    texel = np.asarray(texel[:, :3], np.float32)
    if texel.shape[1] == 1:
        texel = np.repeat(texel, 3, axis=1)
    if data.dtype != np.uint8:          # float textures are 0-1
        texel = texel * 255.0
    return cols * (texel / 255.0)


def _mesh_of(model, registry):
    """(verts f32 [V, 3], tris int32 [T, 3]) of a model: its mesh, else the
    octahedron at 0.7 of its bounding radius (1 for no model)."""
    m = registry.get(int(model)) if model >= 0 else None
    if m is not None and m.vertex_positions is not None \
            and getattr(m, "vertex_triangles", None) is not None and len(m.vertex_triangles):
        return np.asarray(m.vertex_positions, np.float32), np.asarray(m.vertex_triangles, np.int32)
    r = float(m.bounding_radius) if m is not None else 1.0
    return _OCTA_V * (r * 0.7), _OCTA_T


def camera_of(runner, cam_slot: int):
    """(resolved slot, cam pos f32 [3], cam rot f32 [4], fov) of the
    runner's unbatched state, on the host."""
    from lumixengine_tpu_torch.renderer.pipeline import resolve_cam_slot

    st = runner.world.modules["renderer"].statics()
    cam_slot = resolve_cam_slot(st, cam_slot)
    cam_e = max(int(st.cam_slots[cam_slot]), 0)
    state = runner.state
    return (cam_slot, state.world.pos[:, cam_e].cpu().numpy(),
            state.world.rot[:, cam_e].cpu().numpy(),
            float(state.modules["renderer"].cam_fov[cam_slot]))


def rasterize_view(runner, cam_slot: int = 0, width: int = 480, height: int = 270,
                   max_instances: int = 2048):
    """Runner state → shaded uint8 framebuffer [H, W, 3] and depth [H, W]."""
    rmod = runner.world.modules["renderer"]
    cam_slot, cam_pos, cam_rot, fov = camera_of(runner, cam_slot)
    view = runner.prepare_view(cam_slot)
    n_vis = min(int(view.visible_count), max_instances)
    fb = np.full((height, width, 3), 18.0, np.float32)
    zb = np.full((height, width), np.inf, np.float32)
    if n_vis == 0:
        return fb.astype(np.uint8), zb
    ipos = view.instance_pos.cpu().numpy().T[:n_vis]
    irot = view.instance_rot.cpu().numpy().T[:n_vis]
    iscale = view.instance_scale.cpu().numpy().T[:n_vis]
    models = view.instance_model.cpu().numpy()[:n_vis]
    raster_instances(fb, zb, ipos, irot, iscale, models, rmod.system.models, cam_pos, cam_rot,
                     fov, width, height, materials=rmod.system.materials)
    return np.clip(fb, 0, 255).astype(np.uint8), zb


def raster_instances(fb, zb, ipos, irot, iscale, models, registry, cam_pos, cam_rot, fov,
                     width, height, materials=None):
    """Z-buffered fill of instance meshes into fb [H, W, 3] f32 and zb
    [H, W] (mutated in place)."""
    tri_cols_cache = {}
    for i in range(len(models)):
        mid = int(models[i])
        verts, tris = _mesh_of(mid, registry)
        w = hm.quat_rotate(np.broadcast_to(irot[i], (len(verts), 4)), verts * iscale[i]) + ipos[i]
        if mid not in tri_cols_cache:
            tri_cols_cache[mid] = model_triangle_colors(mid, registry, materials)
        raster_mesh(fb, zb, w, tris, model_base_color(mid, registry, materials),
                    cam_pos, cam_rot, fov, width, height, tri_colors=tri_cols_cache[mid])


def raster_mesh(fb, zb, verts_world, tris, base_color, cam_pos, cam_rot, fov, width, height,
                tri_colors=None):
    """Z-buffered fill of one world-space triangle mesh, flat Lambert shade
    tinted by `base_color` [3] 0-255 or per-triangle `tri_colors` [T, 3].
    Mutates fb/zb in place."""
    w = np.asarray(verts_world, np.float32)
    tris = np.asarray(tris, np.int32)
    inv_rot = hm.quat_conjugate(cam_rot)
    f = 1.0 / np.tan(fov * 0.5)
    aspect = width / height
    local = hm.quat_rotate(np.broadcast_to(inv_rot, (len(w), 4)), w - cam_pos)
    depth = -local[:, 2]
    safe = np.maximum(depth, 1e-3)
    sx = ((local[:, 0] * f / aspect) / safe * 0.5 + 0.5) * width
    sy = (1.0 - ((local[:, 1] * f) / safe * 0.5 + 0.5)) * height
    pts = np.stack([sx, sy], -1)

    base = np.asarray(base_color, np.float32)
    tv = pts[tris]                       # [T, 3, 2]
    tz = depth[tris]                     # [T, 3]
    # cull: any vertex behind the camera, or fully off screen
    keep = (tz > 1e-3).all(axis=1)
    keep &= (tv[..., 0].max(axis=1) >= 0) & (tv[..., 0].min(axis=1) < width)
    keep &= (tv[..., 1].max(axis=1) >= 0) & (tv[..., 1].min(axis=1) < height)
    wv = w[tris]                         # [T, 3, 3]
    nrm = np.cross(wv[:, 1] - wv[:, 0], wv[:, 2] - wv[:, 0])
    nlen = np.linalg.norm(nrm, axis=1)
    keep &= nlen > 1e-9
    idxs = np.nonzero(keep)[0]
    if not idxs.size:
        return
    shade = 0.35 + 0.65 * np.abs((nrm[idxs] / nlen[idxs, None]) @ _LIGHT)
    if tri_colors is not None and len(tri_colors) == len(tris):
        cols = np.asarray(tri_colors, np.float32)[idxs] * shade[:, None]
    else:
        cols = base[None, :] * shade[:, None]

    from lumixengine_tpu_torch.utils import native

    if native.raster_available():
        native.raster_tris(fb, zb, tv[idxs], tz[idxs], cols)
        return
    for t, col in zip(idxs, cols):
        a, b, c = tv[t]
        x0 = max(int(np.floor(min(a[0], b[0], c[0]))), 0)
        x1 = min(int(np.ceil(max(a[0], b[0], c[0]))) + 1, width)
        y0 = max(int(np.floor(min(a[1], b[1], c[1]))), 0)
        y1 = min(int(np.ceil(max(a[1], b[1], c[1]))) + 1, height)
        if x0 >= x1 or y0 >= y1:
            continue
        xs = np.arange(x0, x1) + 0.5
        ys = (np.arange(y0, y1) + 0.5)[:, None]
        d = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(d) < 1e-9:
            continue
        w0 = ((b[0] - xs) * (c[1] - ys) - (b[1] - ys) * (c[0] - xs)) / d
        w1 = ((c[0] - xs) * (a[1] - ys) - (c[1] - ys) * (a[0] - xs)) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth by 1/z interpolation
        iz = w0 / tz[t, 0] + w1 / tz[t, 1] + w2 / tz[t, 2]
        z = 1.0 / np.maximum(iz, 1e-9)
        tile_z = zb[y0:y1, x0:x1]
        win = inside & (z < tile_z)
        tile_z[win] = z[win]
        fb[y0:y1, x0:x1][win] = col


def render_png(runner, path: str, cam_slot: int = 0, width: int = 480, height: int = 270,
               max_instances: int = 2048) -> str:
    """Rasterize and save a PNG (the port's own writer, no image package)."""
    from lumixengine_tpu_torch.renderer.texture import write_png

    fb, _ = rasterize_view(runner, cam_slot, width, height, max_instances)
    return write_png(path, fb)
