"""The on-device present (counterpart of ``lumixengine_tpu/renderer/gpu_tpu.py``;
the names are the reference's): the culled scene's triangle soup is
rasterized on the card by a tile-binned pipeline of batched torch ops, and
only the final framebuffer (and the 4-byte overflow count) crosses to the
host.

* **static soup** (``bake_soup``): every (instance, triangle) pair of the
  scene gets a fixed slot, baked on the host once per topology (terrain
  grids, grass blades, instanced-model chunks and procedural geometry join
  as extra instances), so each frame is fixed-shape device work.
* **vertex stage**: every expanded vertex is transformed and projected at
  once (dual-quaternion skinning on the animation palette first, for
  skinned meshes).
* **binning**: each triangle whose screen box spans at most WINDOW x WINDOW
  32-pixel tiles claims those tiles with keys (tile << 18 | depth_q); a
  stable sort gives each tile its triangles near to far, read off by
  searchsorted into a [tiles, k_slots] table. Larger triangles take the
  "large" path: the top-L by screen area (a stable descending sort, ties in
  index order), tested by every tile.
* **z-fill**: chunks of `chunk` slots are tested against each tile's
  1,024 pixel centres with edge-function barycentrics ([tiles, chunk, 1024]
  temporaries); the nearest hit of a chunk (the first at equal depth) wins
  against the z-buffer with a strict less-than, which is the reference's
  slot-by-slot z-test.
* **overflow**: the number of tiles whose dropped triangles (past k_slots)
  could have shown (the first dropped one's depth key is not behind the
  tile's farthest filled pixel), plus the large triangles past large_cap.
  Non-zero means the image may be incomplete.

Shading is ``raster.py``'s (flat |n·L| Lambert, material albedo with the
centroid texel, background 18). ``TpuPresent`` then runs the decal pass,
the clustered lights and the particle splats (summed per pixel in a fixed
order: a stable sort by pixel and a segment sum, so the card repeats
itself bit for bit). The present works on the Runner's unbatched state.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from lumixengine_tpu_torch.core import math as lm
from lumixengine_tpu_torch.renderer.raster import _LIGHT, _mesh_of

TILE = 32          # tile edge in pixels: 32 x 32 = 1024 pixels
KEY_DEPTH_BITS = 18


class SoupStatics(NamedTuple):
    """The host-baked, instance-expanded soup of one topology."""

    vpos: np.ndarray       # f32 [VE, 3] model-local positions
    vinst: np.ndarray      # int32 [VE] owning instance
    tri: np.ndarray        # int32 [E, 3] indices into the expanded vertices
    tinst: np.ndarray      # int32 [E] owning instance (-1: the empty soup)
    tcolor: np.ndarray     # f32 [E, 3] base colour
    num_instances: int
    vbone4: np.ndarray     # int32 [VE, 4] skin bone ids (0 when rigid)
    vweight: np.ndarray    # f32 [VE, 4] skin weights (0 when rigid)
    vskin_col: np.ndarray  # int32 [VE] palette pool column, -1 = rigid


def terrain_mesh(tr: dict, max_grid: int = 128):
    """Heightfield → entity-local triangle mesh decimated to at most
    max_grid² vertices (the software present's grid rule at a larger
    budget), or None."""
    from lumixengine_tpu_torch.renderer.gpu_soft import terrain_grid

    return terrain_grid(tr, max_grid)


def grass_mesh(reg, tid: int, tr: dict, device=None, max_blades: int = 512):
    """Every grass type's blades of one terrain as one entity-local mesh
    (the software present's scatter and blades), or None."""
    from lumixengine_tpu_torch.renderer.gpu_soft import blade_mesh, grass_blades

    verts, tris, base = [], [], 0
    for p, h in grass_blades(reg, tid, tr, device or "cpu", max_blades):
        v, t = blade_mesh(p, h)
        verts.append(v)
        tris.append(t + base)
        base += len(v)
    if not tris:
        return None
    return np.concatenate(verts).astype(np.float32), np.concatenate(tris)


def bake_soup(statics, registry, max_tris_per_model: int = 200_000, materials=None,
              extra_meshes=None, skin_cols=None) -> SoupStatics:
    """Expand (instance, model mesh) into one static soup on the host.
    Models without triangles draw ``raster._mesh_of``'s octahedron; each
    triangle's colour is ``raster.model_triangle_colors`` (the material's
    albedo and its texture at the UV centroid). `extra_meshes` [(verts,
    tris, colour)] become instances numbered after the model instances."""
    from lumixengine_tpu_torch.renderer.raster import model_triangle_colors

    vpos, vinst, tris, tinst, tcol, vb4, vw4, vcol = ([] for _ in range(8))

    def rigid(n_v):
        vb4.append(np.zeros((n_v, 4), np.int32))
        vw4.append(np.zeros((n_v, 4), np.float32))
        vcol.append(np.full(n_v, -1, np.int32))

    voff = 0
    for k in range(len(statics.mi_model)):
        if not statics.mi_mask[k]:
            continue
        mid = int(statics.mi_model[k])
        verts, t = _mesh_of(mid, registry)
        t = t[:max_tris_per_model]
        vpos.append(np.asarray(verts, np.float32))
        vinst.append(np.full(len(verts), k, np.int32))
        tris.append(np.asarray(t, np.int32) + voff)
        tinst.append(np.full(len(t), k, np.int32))
        tcol.append(model_triangle_colors(mid, registry, materials)[: len(t)])
        # real skin rows for a model the animation module poses
        col = -1 if not skin_cols else int(skin_cols.get(int(statics.mi_slots[k]), -1))
        m = registry.get(mid) if mid >= 0 else None
        if (col >= 0 and m is not None and m.vertex_bones4 is not None
                and m.vertex_weights is not None and len(m.vertex_bones4) == len(verts)):
            vb4.append(np.asarray(m.vertex_bones4, np.int32))
            vw4.append(np.asarray(m.vertex_weights, np.float32))
            vcol.append(np.full(len(verts), col, np.int32))
        else:
            rigid(len(verts))
        voff += len(verts)
    n_extra = 0
    for verts, t, color in (extra_meshes or []):
        k = len(statics.mi_model) + n_extra
        vpos.append(np.asarray(verts, np.float32))
        vinst.append(np.full(len(verts), k, np.int32))
        tris.append(np.asarray(t, np.int32) + voff)
        tinst.append(np.full(len(t), k, np.int32))
        tcol.append(np.tile(np.asarray(color, np.float32), (len(t), 1)))
        rigid(len(verts))
        voff += len(verts)
        n_extra += 1
    if not tris:
        vpos, vinst = [np.zeros((3, 3), np.float32)], [np.zeros(3, np.int32)]
        tris, tinst = [np.zeros((1, 3), np.int32)], [np.full(1, -1, np.int32)]
        tcol = [np.zeros((1, 3), np.float32)]
        rigid(3)
    return SoupStatics(
        vpos=np.concatenate(vpos), vinst=np.concatenate(vinst), tri=np.concatenate(tris),
        tinst=np.concatenate(tinst), tcolor=np.concatenate(tcol).astype(np.float32),
        num_instances=len(statics.mi_model) + n_extra, vbone4=np.concatenate(vb4),
        vweight=np.concatenate(vw4), vskin_col=np.concatenate(vcol))


def _first_min(d: torch.Tensor):
    """(min over dim 1, the first index reaching it) of d [N, K, P]: exact
    and order-free, so every device picks the same slot."""
    m = torch.amin(d, dim=1)
    k = torch.arange(d.shape[1], device=d.device)[None, :, None]
    j = torch.amin(torch.where(d == m[:, None], k, d.shape[1]), dim=1)
    return m, j


def make_raster(soup: SoupStatics, width: int, height: int, k_slots: int = 192,
                window: int = 4, large_cap: int = 256, chunk: int = 8, device="cuda"):
    """The raster of one soup on `device`: raster(ipos [3, I], irot [4, I],
    iscale [3, I], visible bool [I], cam_pos [3], cam_rot [4], fov [],
    palette=None) → (rgb uint8 [H, W, 3], depth f32 [H, W], overflow int32
    []). The framebuffer is rounded up to whole tiles and cropped."""
    W = int(np.ceil(width / TILE)) * TILE
    H = int(np.ceil(height / TILE)) * TILE
    tx_n, ty_n = W // TILE, H // TILE
    nt = tx_n * ty_n
    if nt >= 8192:  # (tile << 18 | depth) bin keys must fit int32
        raise ValueError(f"framebuffer {width}x{height} = {nt} tiles; "
                         "the int32 bin-key space caps at 8191 tiles (~2.7K x 1.5K)")
    dev = torch.device(device)
    E = len(soup.tri)
    pix = TILE * TILE

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    # per-tile pixel centres, tile-major [NT, 1024]
    ty, tx = np.divmod(np.arange(nt), tx_n)
    py0 = (ty * TILE)[:, None] + (np.arange(pix) // TILE)[None, :]
    px0 = (tx * TILE)[:, None] + (np.arange(pix) % TILE)[None, :]
    px_c = t(px0.astype(np.float32) + 0.5)[:, None, :]        # [NT, 1, PIX]
    py_c = t(py0.astype(np.float32) + 0.5)[:, None, :]
    i0, i1, i2 = (t(soup.tri[:, c], torch.int64) for c in range(3))
    tinst = t(soup.tinst, torch.int64)
    tinst0 = torch.clamp_min(tinst, 0)
    tcolor = t(soup.tcolor.T)                                 # [3, E]
    vpos = t(soup.vpos.T)                                     # [3, VE]
    vinst = t(soup.vinst, torch.int64)
    light = [np.float32(x) for x in _LIGHT]
    aspect = width / height
    n_keys = E * window * window
    s = torch.arange(window * window, dtype=torch.int32, device=dev)
    sx_off, sy_off = s % window, s // window
    tri_of_key = torch.arange(E, dtype=torch.int32, device=dev)[:, None] \
        .expand(E, window * window).reshape(-1)
    bounds = torch.arange(nt + 1, dtype=torch.int32, device=dev) << KEY_DEPTH_BITS
    kk = torch.arange(k_slots, dtype=torch.int64, device=dev)
    L = min(large_cap, E)
    L_pad = ((L + chunk - 1) // chunk) * chunk
    big_pad = torch.full((L_pad - L,), -1, dtype=torch.int64, device=dev)
    bg = torch.full((nt, pix), 18.0, dtype=torch.float32, device=dev)
    # skinned vertices: dual-quaternion skinning on the palette in the vertex stage
    has_skin = bool(np.any(soup.vskin_col >= 0))
    if has_skin:
        vb = t(soup.vbone4, torch.int64)
        vw = t(soup.vweight)
        vc = t(np.maximum(soup.vskin_col, 0), torch.int64)
        vmask = t(soup.vskin_col >= 0)

    def posed(palette):
        dqs = palette[:, vb, vc[:, None]]                     # [8, VE, 4]
        ref = dqs[:4, :, 0:1]
        d = torch.sum(dqs[:4] * ref, dim=0)
        w = vw * torch.where(d < 0.0, np.float32(-1.0), np.float32(1.0))
        dq = torch.einsum("cvk,vk->cv", dqs, w)
        dq = lm.dual_quat_normalize(dq, axis=0)
        return torch.where(vmask[None], lm.dual_quat_transform(dq, vpos, axis=0), vpos)

    def fill(zbuf, r, g, b, setup, cols, ok):
        """Z-test slot chunks: setup [10, N, S], cols [3, N, S], ok [N, S];
        N is NT for the binned table, 1 for the large list."""
        n_chunks = setup.shape[-1] // chunk
        for i in range(n_chunks):
            sl = slice(i * chunk, (i + 1) * chunk)
            gax, gay, gbx, gby, gcx, gcy, ga2, iza, izb, izc = (a[..., None] for a in
                                                                setup[:, :, sl])
            w0 = ((gby - gcy) * (px_c - gcx) + (gcx - gbx) * (py_c - gcy)) / ga2
            w1 = ((gcy - gay) * (px_c - gax) + (gax - gcx) * (py_c - gay)) / ga2
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (ok[:, sl, None] > 0)
            zinv = w0 * iza + w1 * izb + w2 * izc
            d = torch.where(inside & (zinv > 1e-9), 1.0 / zinv, math.inf)   # [NT, kc, PIX]
            m, j = _first_min(d)
            upd = m < zbuf
            zbuf = torch.where(upd, m, zbuf)
            cc = cols[:, :, sl].expand(3, nt, chunk)
            r = torch.where(upd, torch.gather(cc[0], 1, j), r)
            g = torch.where(upd, torch.gather(cc[1], 1, j), g)
            b = torch.where(upd, torch.gather(cc[2], 1, j), b)
        return zbuf, r, g, b

    def untile(x):
        return x.reshape(ty_n, tx_n, TILE, TILE).permute(0, 2, 1, 3).reshape(H, W)[:height, :width]

    def raster(ipos, irot, iscale, visible, cam_pos, cam_rot, fov, palette=None):
        # -- vertex stage: world → camera → screen -------------------------
        local_v = vpos if (palette is None or not has_skin) else posed(palette)
        scale_v = iscale.index_select(-1, vinst)
        rot_v = irot.index_select(-1, vinst)
        pos_v = ipos.index_select(-1, vinst)
        wv = lm.quat_rotate(rot_v, local_v * scale_v, axis=0) + pos_v
        inv = lm.quat_conjugate(cam_rot, axis=0)
        local = lm.quat_rotate(inv[:, None], wv - cam_pos[:, None], axis=0)
        depth = -local[2]
        safe = torch.clamp_min(depth, 1e-3)
        f = 1.0 / torch.tan(fov * 0.5)
        sx = ((local[0] * f / aspect) / safe * 0.5 + 0.5) * width
        sy = (1.0 - ((local[1] * f) / safe * 0.5 + 0.5)) * height

        # -- triangle setup --------------------------------------------------
        ax, ay, az = sx[i0], sy[i0], depth[i0]
        bx, by, bz = sx[i1], sy[i1], depth[i1]
        cx, cy, cz = sx[i2], sy[i2], depth[i2]
        area2 = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        vis_t = visible[tinst0] & (tinst >= 0)
        keep = vis_t & (az > 1e-3) & (bz > 1e-3) & (cz > 1e-3) & (torch.abs(area2) > 1e-9)
        e1 = [wv[c][i1] - wv[c][i0] for c in range(3)]
        e2 = [wv[c][i2] - wv[c][i0] for c in range(3)]
        nx = e1[1] * e2[2] - e1[2] * e2[1]
        ny = e1[2] * e2[0] - e1[0] * e2[2]
        nz = e1[0] * e2[1] - e1[1] * e2[0]
        nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
        keep &= nlen > 1e-9
        ndl = torch.abs(nx * light[0] + ny * light[1] + nz * light[2]) \
            / torch.clamp_min(nlen, 1e-9)
        col = tcolor * (0.35 + 0.65 * ndl)                    # [3, E]

        minx = torch.minimum(torch.minimum(ax, bx), cx)
        maxx = torch.maximum(torch.maximum(ax, bx), cx)
        miny = torch.minimum(torch.minimum(ay, by), cy)
        maxy = torch.maximum(torch.maximum(ay, by), cy)
        keep &= (maxx >= 0) & (minx < width) & (maxy >= 0) & (miny < height)

        def tile_of(v, n):
            return torch.clamp(torch.floor(v / TILE), 0, n - 1).to(torch.int32)

        tx0, tx1 = tile_of(minx, tx_n), tile_of(maxx, tx_n)
        ty0, ty1 = tile_of(miny, ty_n), tile_of(maxy, ty_n)
        small = keep & (tx1 - tx0 + 1 <= window) & (ty1 - ty0 + 1 <= window)
        large = keep & ~small

        # -- binning: (tile, depth) keys, stably sorted, read off per tile ---
        cand_tx = tx0[:, None] + sx_off[None, :]
        cand_ty = ty0[:, None] + sy_off[None, :]
        cand_ok = small[:, None] & (cand_tx <= tx1[:, None]) & (cand_ty <= ty1[:, None])
        minz = torch.minimum(torch.minimum(az, bz), cz)
        depth_q = (minz / (minz + 32.0) * 262143.0).to(torch.int32)        # 18 bits
        tile_id = cand_ty * tx_n + cand_tx
        key = torch.where(cand_ok, (tile_id << KEY_DEPTH_BITS) | depth_q[:, None],
                          nt << KEY_DEPTH_BITS).reshape(-1)
        skey, order = torch.sort(key, stable=True)
        stri = tri_of_key[order]
        starts = torch.searchsorted(skey, bounds[:-1])
        counts = torch.searchsorted(skey, bounds[1:]) - starts             # [NT]
        slot_pos = torch.clamp_max(starts[:, None] + kk[None, :], n_keys - 1)
        slot_tri = torch.where(kk[None, :] < torch.clamp_max(counts, k_slots)[:, None],
                               stri[slot_pos].to(torch.int64), -1)          # [NT, KS]

        # large triangles: the top L by |area| (ties in index order)
        big_score = torch.where(large, torch.abs(area2), np.float32(-1.0))
        top_score, top_idx = torch.sort(big_score, descending=True, stable=True)
        big_tri = torch.cat([torch.where(top_score[:L] > 0.0, top_idx[:L], -1), big_pad])
        large_dropped = torch.clamp_min(torch.sum(large, dtype=torch.int32) - large_cap, 0)

        # -- fill ------------------------------------------------------------
        setup_all = torch.stack([ax, ay, bx, by, cx, cy, area2, 1.0 / az, 1.0 / bz,
                                 1.0 / cz])                                 # [10, E]

        def slot_layout(idx):
            ti = torch.clamp_min(idx, 0)
            return setup_all[:, ti], col[:, ti], (idx >= 0).to(torch.float32)

        zbuf = torch.full((nt, pix), math.inf, dtype=torch.float32, device=dev)
        carry = (zbuf, bg, bg, bg)
        ks_pad = ((k_slots + chunk - 1) // chunk) * chunk
        st = torch.nn.functional.pad(slot_tri, (0, ks_pad - k_slots), value=-1)
        carry = fill(*carry, *slot_layout(st))
        carry = fill(*carry, *slot_layout(big_tri[None, :]))
        zbuf, r, g, b = carry

        # -- the occlusion-sound completeness certificate --------------------
        zmax_t = torch.amax(zbuf, dim=1)
        zmax_q = torch.where(torch.isfinite(zmax_t),
                             (zmax_t / (zmax_t + 32.0) * 262143.0).to(torch.int32), 262144)
        first_drop = torch.where(counts > k_slots,
                                 skey[torch.clamp_max(starts + k_slots, n_keys - 1)] & 0x3FFFF,
                                 262145)
        incomplete = (counts > k_slots) & (first_drop <= zmax_q)
        overflow = torch.sum(incomplete, dtype=torch.int32) + large_dropped

        rgb = torch.stack([untile(r), untile(g), untile(b)], dim=-1)
        return torch.clamp(rgb, 0, 255).to(torch.uint8), untile(zbuf), overflow

    return raster


def _decal_rows(rmod, world, device):
    """The decals' static rows on `device` (``gpu_soft.decal_rows``), or None."""
    from lumixengine_tpu_torch.renderer.gpu_soft import decal_rows

    rows = decal_rows(rmod, world)
    if rows is None:
        return None
    return tuple(torch.as_tensor(a, device=device) for a in rows)


def _particle_rows(rmod):
    """[(emitter component key, emitter name, pos_row, col_row, col_width,
    size_row)] for every emitter with a position output."""
    from lumixengine_tpu_torch.renderer.gpu_soft import particle_rows

    out = []
    for key, (_e, ps) in dict(rmod.particle_emitters).items():
        for ekey, em in getattr(ps, "emitters", {}).items():
            rows = particle_rows(em)
            if rows is not None:
                out.append((key, ekey, *rows))
    return out


def splat_particles(rgb_f, zbuf, est, rows, cam_pos, cam_rot, fov, width: int, height: int):
    """Additive 3x3 point splats with a z-test and depth write (the software
    present's rule: the centre always, a ring where the splat radius
    exceeds 1.6 pixels a ring, 0.8 of the colour). The adds are summed per
    pixel in a fixed order (a stable sort by pixel, then a segment sum), so
    the result does not depend on the device's scheduling. rgb_f float
    0-255 [H, W, 3] → (rgb_f', zbuf')."""
    pos_row, col_row, col_w, size_row = rows
    pos = est.outs[pos_row:pos_row + 3]
    alive = est.alive
    inv = lm.quat_conjugate(cam_rot, axis=0)
    local = lm.quat_rotate(inv[:, None], pos - cam_pos[:, None], axis=0)
    depth = -local[2]
    safe = torch.clamp_min(depth, 1e-3)
    f = 1.0 / torch.tan(fov * 0.5)
    aspect = width / height
    sx = ((local[0] * f / aspect) / safe * 0.5 + 0.5) * width
    sy = (1.0 - ((local[1] * f) / safe * 0.5 + 0.5)) * height
    ok = alive & (depth > 1e-3) & (sx >= 0) & (sx < width) & (sy >= 0) & (sy < height)
    xi = torch.clamp(sx.to(torch.int32), 0, width - 1).to(torch.int64)
    yi = torch.clamp(sy.to(torch.int32), 0, height - 1).to(torch.int64)
    if col_row >= 0:
        col = torch.clamp(est.outs[col_row:col_row + 3], 0.0, 4.0)
        if col_w >= 4:
            col = col * torch.clamp(est.outs[col_row + 3][None], 0.0, 1.0)
        col = col * 255.0
    else:
        col = torch.full((3,) + alive.shape, 80.0, dtype=torch.float32, device=alive.device)
    sc = est.outs[size_row] if size_row >= 0 else torch.full_like(depth, 0.15)
    px = torch.clamp(sc * f / safe * height * 0.5, 0.5, 6.0)
    hw = height * width
    flat_z = zbuf.reshape(-1)
    vis = ok & (depth < flat_z[yi * width + xi])
    targets = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ring = max(abs(dy), abs(dx))
            sel = vis & ((px > 1.6 * ring) if ring else (px >= 0.0))
            l2 = torch.clamp(yi + dy, 0, height - 1) * width + torch.clamp(xi + dx, 0, width - 1)
            targets.append(torch.where(sel, l2, hw))                # hw: the trash pixel
    tgt = torch.cat(targets)                                         # [9 · cap], ring-major
    add = (col * 0.8).T.repeat(9, 1)                                 # [9 · cap, 3]
    skey, perm = torch.sort(tgt, stable=True)
    offsets = torch.searchsorted(skey, torch.arange(hw + 2, device=tgt.device))
    sums = torch.segment_reduce(add[perm], "sum", offsets=offsets, axis=0, unsafe=True,
                                initial=0.0)[:hw]
    rgb = (rgb_f.reshape(-1, 3) + sums).reshape(rgb_f.shape)
    zs = torch.where(tgt < hw, depth.repeat(9), math.inf)
    z = flat_z.scatter_reduce(0, torch.clamp_max(tgt, hw - 1), zs, "amin", include_self=True)
    return rgb, z.reshape(zbuf.shape)


class TpuPresent:
    """The cached on-device present of a Runner: the soup and the raster are
    rebuilt when (topology_version, camera slot) changes and reused across
    frames otherwise. Extra options (k_slots, window, large_cap, chunk) go
    to ``make_raster``."""

    def __init__(self, width: int = 480, height: int = 270, lights: bool = True,
                 particles: bool = True, **kw):
        self.width, self.height = width, height
        self.kw = kw
        self.lights = lights
        self.particles = particles
        self._frame = None
        self._soup_version = None
        self.soup = None

    def _extra_meshes(self, rmod, world, device):
        """Terrain grids and their grass, instanced-model chunks (each
        sub-instance pre-transformed into the owner's space) and procedural
        geometry: [(verts, tris, colour)] and their entity slots."""
        from lumixengine_tpu_torch.core import host_math as hm
        from lumixengine_tpu_torch.renderer.raster import model_base_color

        extra, slots = [], []
        treg, tstore = rmod.system.terrains, rmod.terrains
        for e, tid in zip(np.asarray(tstore.entity), np.asarray(tstore.data["terrain"])):
            if e < 0 or tid < 0:
                continue
            try:
                tr = treg.get(int(tid))
            except (KeyError, IndexError):
                continue
            tm = terrain_mesh(tr)
            if tm is None:
                continue
            extra.append((tm[0], tm[1], np.array([89, 140, 79], np.float32)))
            slots.append(world.slot(int(e)))
            if tr.get("grass_types"):
                gm = grass_mesh(treg, int(tid), tr, device)
                if gm is not None:
                    extra.append((gm[0], gm[1], np.array([96, 168, 72], np.float32)))
                    slots.append(world.slot(int(e)))
        for ent, im in rmod.instanced_models.items():
            mid = int(im["model"])
            verts, t = _mesh_of(mid, rmod.system.models)
            n_sub = len(im["pos"])
            if n_sub == 0 or len(t) == 0:
                continue
            if n_sub * len(t) > 200_000:     # the static soup's budget
                n_sub = max(200_000 // len(t), 1)
            V = len(verts)
            vv = np.tile(verts, (n_sub, 1)) * np.repeat(im["scale"][:n_sub], V, axis=0)
            vv = hm.quat_rotate(np.repeat(im["rot"][:n_sub], V, axis=0), vv) \
                + np.repeat(im["pos"][:n_sub], V, axis=0)
            tt = (np.tile(t, (n_sub, 1))
                  + (np.repeat(np.arange(n_sub), len(t)) * V)[:, None]).astype(np.int32)
            extra.append((vv.astype(np.float32), tt,
                          model_base_color(mid, rmod.system.models, rmod.system.materials)))
            slots.append(world.slot(int(ent)))
        for ent, pg in rmod.procedural_geometries.items():
            verts = np.asarray(pg.get("vertices", ()), np.float32)
            n = (len(verts) // 3) * 3
            if n == 0:
                continue
            extra.append((verts[:n], np.arange(n, dtype=np.int32).reshape(-1, 3),
                          np.array([176, 122, 161], np.float32)))
            slots.append(world.slot(int(ent)))
        return extra, slots

    def _build(self, runner, cam_slot: int, device):
        from lumixengine_tpu_torch.renderer import clusters as _cls
        from lumixengine_tpu_torch.renderer import postprocess as pp
        from lumixengine_tpu_torch.renderer.gpu_soft import skin_map

        world = runner.world
        rmod = world.modules["renderer"]
        st = rmod.statics()
        extra, extra_slots = self._extra_meshes(rmod, world, device)
        soup = bake_soup(st, rmod.system.models, materials=rmod.system.materials,
                         extra_meshes=extra, skin_cols=skin_map(world))
        raster = make_raster(soup, self.width, self.height, device=device, **self.kw)
        has_skin = bool(np.any(soup.vskin_col >= 0)) and "animation" in world.modules
        eidx = torch.as_tensor(np.concatenate([np.maximum(st.mi_slots, 0),
                                               np.asarray(extra_slots, np.int64)]).astype(np.int64),
                               device=device)
        extra_vis = torch.ones(len(extra_slots), dtype=torch.bool, device=device)
        cam_e = max(int(st.cam_slots[cam_slot]), 0)
        has_lights = self.lights and st.pl_slots.size > 0 and bool(np.any(st.pl_mask))
        prt_rows = _particle_rows(rmod) if self.particles else []
        dec = _decal_rows(rmod, world, device)
        le = torch.as_tensor(np.maximum(st.pl_slots, 0).astype(np.int64), device=device)
        aspect = self.width / self.height
        width, height = self.width, self.height

        def raster_stage(state):
            """The instance gathers and the raster → (rgb, zbuf, overflow)."""
            wpos, wrot = state.world.pos, state.world.rot
            rs = state.modules["renderer"]
            vis = torch.cat([rs.mi_visible, extra_vis]) if len(extra_slots) else rs.mi_visible
            pal = state.modules["animation"].palette if has_skin else None
            return raster(wpos.index_select(-1, eidx), wrot.index_select(-1, eidx),
                          state.world.scale.index_select(-1, eidx), vis, wpos[:, cam_e],
                          wrot[:, cam_e], rs.cam_fov[cam_slot], palette=pal)

        def passes_stage(state, rgb, zbuf):
            """The decal pass, the clustered lights and the particle splats
            → (rgb, zbuf)."""
            wpos, wrot = state.world.pos, state.world.rot
            rs = state.modules["renderer"]
            cam_pos, cam_rot = wpos[:, cam_e], wrot[:, cam_e]
            fov = rs.cam_fov[cam_slot]
            if dec is not None:
                slots_d, loc, lrot, he_d, tint_d = dec
                ep, er = wpos.index_select(-1, slots_d), wrot.index_select(-1, slots_d)
                dpos = ep + lm.quat_rotate(er, loc, axis=0)
                drot = lm.quat_mul(er, lrot, axis=0)
                out = pp.decal_pass(rgb.to(torch.float32) / 255.0, zbuf, fov, aspect, cam_pos,
                                    cam_rot, dpos.T, drot.T, he_d, tint_d)
                rgb = torch.clamp(out * 255.0, 0, 255).to(torch.uint8)
            if has_lights:
                cl = _cls.fill_clusters(state, rmod, cam_slot=cam_slot, statics=st)
                lw = wpos.index_select(-1, le)
                inv = lm.quat_conjugate(cam_rot, axis=0)
                lv = lm.quat_rotate(inv[:, None], lw - cam_pos[:, None], axis=0).T
                lit = pp.deferred_lights(rgb.to(torch.float32) / 255.0, zbuf, fov, aspect, lv,
                                         rs.pl_color.T, rs.pl_intensity, rs.pl_range, cl.lights,
                                         grid=_cls.GRID, near=rs.cam_near[cam_slot],
                                         far_cluster=rs.cam_far[cam_slot])
                rgb = torch.clamp(lit * 255.0, 0, 255).to(torch.uint8)
            if prt_rows:
                # splats draw after the light pass: they own their depth but
                # have no surface normal for the deferred shading
                rgb_f = rgb.to(torch.float32)
                for key, ekey, *rows in prt_rows:
                    est = rs.particles.get(key, {}).get(ekey)
                    if est is not None:
                        rgb_f, zbuf = splat_particles(rgb_f, zbuf, est, tuple(rows), cam_pos,
                                                      cam_rot, fov, width, height)
                rgb = torch.clamp(rgb_f, 0, 255).to(torch.uint8)
            return rgb, zbuf

        def frame(state):
            """One present, with no host sync inside."""
            rgb, zbuf, overflow = raster_stage(state)
            rgb, zbuf = passes_stage(state, rgb, zbuf)
            return rgb, zbuf, overflow

        self.soup = soup
        self.raster_stage, self.passes_stage = raster_stage, passes_stage
        self._frame = frame

    def device_frame(self, runner, cam_slot: int = 0):
        """The present of the runner's state as device tensors (rgb uint8
        [H, W, 3], depth f32 [H, W], overflow int32 []); the visibility is
        the step's own cull output (``mi_visible``), so presenting adds no
        cull."""
        from lumixengine_tpu_torch.renderer.gpu_soft import require_unbatched
        from lumixengine_tpu_torch.renderer.pipeline import resolve_cam_slot

        state = runner.state
        require_unbatched(state)
        world = runner.world
        cam_slot = resolve_cam_slot(world.modules["renderer"].statics(), cam_slot)
        ver = (world.topology_version, cam_slot)
        if self._frame is None or self._soup_version != ver:
            self._build(runner, cam_slot, state.world.pos.device)
            self._soup_version = ver
        return self._frame(state)

    def __call__(self, runner, cam_slot: int = 0):
        return self.device_frame(runner, cam_slot)
