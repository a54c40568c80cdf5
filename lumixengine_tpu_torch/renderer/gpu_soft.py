"""The software present (counterpart of ``lumixengine_tpu/renderer/gpu_soft.py``):
``SoftwareGpuBackend`` replays every command of a recorded DrawStream.

Rasterization stays on the host, as in the reference: instance draws,
instanced-model chunks, terrains with their grass, procedural geometry and
particle splats fill a numpy framebuffer through ``raster.py``. Each
OP_DISPATCH then runs its pass of ``postprocess.py`` on the device of the
runner's state (the card, unless the caller runs on the CPU): the decal
projection and the clustered lights write back into the host framebuffer
(scene content, before the plugins), every other pass works on the HDR
colour on the device until ``finish`` reads the image back. The GUI
overlay is host content too (``compose_gui``).

The present works on the Runner's unbatched state; a state replicated over
worlds raises ``ValueError``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lumixengine_tpu_torch.core import host_math as hm
from lumixengine_tpu_torch.core import random as prng
from lumixengine_tpu_torch.renderer import postprocess as pp
from lumixengine_tpu_torch.renderer import raster


def require_unbatched(state) -> None:
    if state.world.pos.dim() != 2:
        raise ValueError(f"the presents draw one world; this state holds a batch of "
                         f"{state.world.pos.shape[0]} (present one world's state)")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SoftwareGpuBackend:
    """One frame's replay target: construct (passing the previous frame's
    history keeps TAA accumulating), replay a stream, then ``finish()``."""

    def __init__(self, runner, cam_slot: int = 0, width: int = 480, height: int = 270,
                 max_instances: int = 2048, exposure: float = 1.3):
        self.runner = runner
        self.width, self.height = width, height
        self.max_instances = max_instances
        self.exposure = exposure
        state = runner.state
        require_unbatched(state)
        self.device = state.world.pos.device
        self.rmod = runner.world.modules["renderer"]
        rs = state.modules["renderer"]
        self.cam_slot, self.cam_pos, self.cam_rot, self.fov = raster.camera_of(runner, cam_slot)
        self.far = float(rs.cam_far[self.cam_slot])
        self.aspect = width / height
        # the directional light: the environment entity's forward (-Z), else a
        # fixed key light
        env = int(rs.env_entity)
        if env >= 0:
            erot = _host(state.world.rot[:, env])
            self.sun_dir = -hm.quat_rotate(erot[None], np.array([[0.0, 0.0, -1.0]], np.float32))[0]
        else:
            self.sun_dir = np.array([0.45, 0.8, 0.35], np.float32)
        self.sun_dir = self.sun_dir / np.linalg.norm(self.sun_dir)
        self._wpos = _host(state.world.pos)
        self._wrot = _host(state.world.rot)
        self.fb = np.full((height, width, 3), 18.0, np.float32)
        self.zb = np.full((height, width), np.inf, np.float32)
        self.color: Optional[torch.Tensor] = None   # linear HDR on the device
        self.depth: Optional[torch.Tensor] = None
        self.history: Optional[torch.Tensor] = None  # TAA
        self.frame_index = int(state.frame)
        self.pass_name = ""
        self._bound = None
        self._rays = None
        self._skin = None
        self._scene_spheres = None
        self.draw_calls = 0

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.device)

    def _mesh(self, verts_world, tris, color):
        raster.raster_mesh(self.fb, self.zb, verts_world, tris, color, self.cam_pos,
                           self.cam_rot, self.fov, self.width, self.height)

    def _entity_pose(self, entity):
        slot = self.runner.world.slot(entity)
        return self._wpos[:, slot], self._wrot[:, slot]

    # -- raster ops ---------------------------------------------------------

    def set_pass(self, name: str = "?"):
        self.pass_name = name

    def bind_material(self, **kw):
        pass

    def bind_palettes(self, **kw):
        pass

    def bind_instances(self, pos=None, rot=None, scale=None, models=None, count=None, slots=None,
                       **kw):
        n = min(int(count), self.max_instances) if count is not None else 0
        self._bound = None
        if n:
            self._bound = (_host(pos).T[:n], _host(rot).T[:n], _host(scale).T[:n],
                           _host(models)[:n],
                           _host(slots)[:n] if slots is not None else np.full(n, -1, np.int32))

    def draw_instanced(self, **kw):
        self.draw_calls += 1
        if kw.get("source") == "instanced_model":
            return self._draw_instanced_chunk(kw.get("chunk", 0), kw.get("model", -1))
        if self._bound is None:
            return
        ipos, irot, iscale, models, slots = self._bound
        registry, materials = self.rmod.system.models, self.rmod.system.materials
        # skinned instances draw their posed mesh (dual-quaternion skinning on
        # the animation palette), the rest their bind-pose mesh
        skins = self._skin_map()
        drawn = np.zeros(len(models), bool)
        pal = None
        for i, slot in enumerate(slots if skins else ()):
            col = skins.get(int(slot))
            if col is None:
                continue
            m = registry.get(int(models[i])) if models[i] >= 0 else None
            if m is None or m.vertex_weights is None or m.vertex_positions is None \
                    or m.vertex_triangles is None:
                continue
            if pal is None:
                pal = _host(self.runner.state.modules["animation"].palette)
            posed = skin_points_dq_np(pal[:, :, col], np.asarray(m.vertex_positions),
                                      np.asarray(m.vertex_bones4), np.asarray(m.vertex_weights))
            w = hm.quat_rotate(np.broadcast_to(irot[i], (len(posed), 4)), posed * iscale[i]) \
                + ipos[i]
            self._mesh(w, m.vertex_triangles,
                       raster.model_base_color(int(models[i]), registry, materials))
            drawn[i] = True
        keep = ~drawn
        raster.raster_instances(self.fb, self.zb, ipos[keep], irot[keep], iscale[keep],
                                models[keep], registry, self.cam_pos, self.cam_rot, self.fov,
                                self.width, self.height, materials=materials)
        self._bound = None

    def _skin_map(self):
        if self._skin is None:
            self._skin = skin_map(self.runner.world)
        return self._skin

    def draw_model(self, **kw):
        if kw.get("source") == "procedural_geometry":
            return self._draw_procedural(kw.get("entity"))
        self.draw_instanced(**kw)

    def _draw_procedural(self, entity):
        """Triangle-soup fill (consecutive vertex triples) at the entity's
        transform."""
        self.draw_calls += 1
        pg = self.rmod.procedural_geometries.get(entity)
        if not pg or not len(pg["vertices"]):
            return
        verts = np.asarray(pg["vertices"], np.float32)
        n = (len(verts) // 3) * 3
        if n == 0:
            return
        epos, erot = self._entity_pose(entity)
        w = hm.quat_rotate(np.broadcast_to(erot, (n, 4)), verts[:n]) + epos
        self._mesh(w, np.arange(n, dtype=np.int32).reshape(-1, 3),
                   np.array([176, 122, 161], np.float32))

    def _draw_instanced_chunk(self, chunk: int, model: int):
        """One culled instanced-model chunk; its instance transforms are
        relative to the owner entity's position. At most max_instances."""
        ims = [(e, im) for e, im in self.rmod.instanced_models.items() if len(im["pos"])]
        if not (0 <= chunk < len(ims)):
            return
        owner, im = ims[chunk]
        n = min(len(im["pos"]), self.max_instances)
        if n == 0:
            return
        epos, _ = self._entity_pose(owner)
        models = np.full(n, im["model"] if model < 0 else model, np.int32)
        raster.raster_instances(self.fb, self.zb, im["pos"][:n] + epos, im["rot"][:n],
                                im["scale"][:n], models, self.rmod.system.models, self.cam_pos,
                                self.cam_rot, self.fov, self.width, self.height,
                                materials=self.rmod.system.materials)

    def draw_particles(self, emitter=None, **kw):
        """Alive particles' position output as additive 3x3 point splats."""
        self.draw_calls += 1
        rs = self.runner.state.modules["renderer"]
        sub = rs.particles.get(emitter) if emitter else None
        if not sub:
            return
        ps = dict(self.rmod.particle_emitters).get(emitter)
        ps = ps[1] if ps else None
        for ekey, est in sub.items():
            em = getattr(ps, "emitters", {}).get(ekey) if ps else None
            pos3, col, size = _particle_outputs(est, em)
            if pos3 is None:
                continue
            alive = _host(est.alive)
            pts = pos3[alive]
            if not len(pts):
                continue
            cols = col[alive] * 255.0 if col is not None \
                else np.full((len(pts), 3), 80.0, np.float32)
            xy, depth = _project_np(pts, self.cam_pos, self.cam_rot, self.fov, self.aspect,
                                    self.width, self.height)
            ok = (depth > 1e-3) & (xy[:, 0] >= 0) & (xy[:, 0] < self.width) \
                & (xy[:, 1] >= 0) & (xy[:, 1] < self.height)
            xi = xy[ok, 0].astype(np.int32)
            yi = xy[ok, 1].astype(np.int32)
            zok = depth[ok] < self.zb[yi, xi]
            f = 1.0 / np.tan(self.fov * 0.5)
            sc = size[alive][ok] if size is not None else np.full(ok.sum(), 0.15, np.float32)
            px = np.clip(sc * f / np.maximum(depth[ok], 1e-3) * self.height * 0.5, 0.5, 6.0)
            yi, xi, px = yi[zok], xi[zok], px[zok]
            cz = cols[ok][zok]
            dz = depth[ok][zok]
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ring = max(abs(dy), abs(dx))
                    sel = (px >= 0.0) if ring == 0 else (px > 1.6 * ring)
                    y2 = np.clip(yi[sel] + dy, 0, self.height - 1)
                    x2 = np.clip(xi[sel] + dx, 0, self.width - 1)
                    np.add.at(self.fb, (y2, x2), cz[sel] * 0.8)
                    # splats own their depth: the sky and fog passes see them
                    np.minimum.at(self.zb, (y2, x2), dz[sel])

    def draw_terrain(self, entity=None, terrain=-1, **kw):
        """The heightfield as a grid mesh decimated to at most 48 x 48
        vertices, then its grass."""
        self.draw_calls += 1
        reg = self.rmod.system.terrains
        if terrain < 0 or entity is None:
            return
        try:
            tr = reg.get(int(terrain))
        except (KeyError, IndexError):
            return
        mesh = terrain_grid(tr, 48)
        if mesh is None:
            return
        verts, tris = mesh
        epos, erot = self._entity_pose(entity)
        w = hm.quat_rotate(np.broadcast_to(erot, (len(verts), 4)), verts) + epos
        self._mesh(w, tris, np.array([89, 140, 79], np.float32))
        if tr.get("grass_types"):
            self._draw_grass(int(terrain), tr, epos, erot)

    def _draw_grass(self, tid: int, tr, epos, erot, max_blades: int = 512):
        """Each grass type's seeded scatter as one blade-triangle mesh."""
        for p, h in grass_blades(self.rmod.system.terrains, tid, tr, self.device, max_blades):
            pw_ = hm.quat_rotate(np.broadcast_to(erot, (len(p), 4)), p) + epos
            verts, tris = blade_mesh(pw_, h)
            self._mesh(verts, tris, np.array([96, 168, 72], np.float32))

    def draw_2d(self, **kw):
        """The GUI overlay (rects, font-atlas glyphs, carets), after the
        tonemap when the device colour path is live."""
        self.draw_calls += 1
        if self.runner.world.modules.get("gui") is None:
            return
        buf = _host(self.color) * 255.0 if self.color is not None else self.fb
        compose_gui(buf, self.runner, self.width, self.height)
        if self.color is not None:
            self.color = self._t(np.clip(buf, 0, 255) / 255.0)

    def draw_nav_debug(self, nav_module=None, y: float = 0.1):
        """Navigation debug: cyan dots on walkable cells next to blocked ones,
        orange on blocked cells, at ground height."""
        nav = nav_module or self.runner.world.modules.get("navigation")
        if nav is None:
            return
        zone = getattr(nav, "zone", None)
        if zone is None:
            return
        wk = zone.walkable
        blocked = ~wk
        nb = np.zeros_like(wk)
        nb[1:] |= blocked[:-1]
        nb[:-1] |= blocked[1:]
        nb[:, 1:] |= blocked[:, :-1]
        nb[:, :-1] |= blocked[:, 1:]
        for mask, col in ((wk & nb, (90.0, 220.0, 220.0)), (blocked, (230.0, 140.0, 40.0))):
            zc, xc = np.nonzero(mask)
            if not len(zc):
                continue
            wx = zone.origin[0] + (xc + 0.5) * zone.cell
            wz = zone.origin[1] + (zc + 0.5) * zone.cell
            pts = np.stack([wx, np.full_like(wx, y), wz], -1).astype(np.float32)
            xy, depth = _project_np(pts, self.cam_pos, self.cam_rot, self.fov, self.aspect,
                                    self.width, self.height)
            ok = (depth > 1e-3) & (xy[:, 0] >= 0) & (xy[:, 0] < self.width) \
                & (xy[:, 1] >= 0) & (xy[:, 1] < self.height)
            xi = xy[ok, 0].astype(np.int32)
            yi = xy[ok, 1].astype(np.int32)
            zok = depth[ok] < self.zb[yi, xi] + 0.5
            if self.color is not None:
                img = _host(self.color).copy()
                img[yi[zok], xi[zok]] = np.asarray(col) / 255.0
                self.color = self._t(img)
            else:
                self.fb[yi[zok], xi[zok]] = np.asarray(col, np.float32)

    def barrier(self, **kw):
        pass

    def unknown(self, op=None, **kw):
        pass

    # -- dispatch: the post-process passes on the device -------------------

    def _to_device(self):
        if self.color is None:
            self.color = self._t(self.fb) / 255.0
            self.depth = self._t(self.zb)

    def _world_rays(self):
        if self._rays is None:
            self._rays = pp.world_rays(self._t(self.cam_rot), self.fov, self.aspect,
                                       self.height, self.width)
        return self._rays

    def dispatch(self, shader: str = "", **params):
        if shader == "decals":
            return self._run_decals(params)
        if shader == "deferred_lights":
            return self._run_lights(params)
        self._to_device()
        c, d = self.color, self.depth
        if shader == "tonemap":
            c = pp.tonemap_aces(c, params.get("exposure", self.exposure))
        elif shader == "bloom":
            c = pp.bloom(c, params.get("threshold", 0.85), params.get("intensity", 0.6))
        elif shader == "ssao":
            ao = pp.ssao(d, self.fov, self.aspect, params.get("radius", 0.8),
                         params.get("strength", 1.0), far=self.far)
            c = c * ao[..., None]
        elif shader == "sss":
            sun_view = hm.quat_rotate(hm.quat_conjugate(self.cam_rot)[None],
                                      self.sun_dir[None].astype(np.float32))[0]
            lit = pp.sss_shadow(d, self.fov, self.aspect, self._t(sun_view),
                                steps=int(params.get("steps", 8)),
                                shadow=params.get("shadow", 0.45), far=self.far)
            c = c * lit[..., None]
        elif shader == "tdao":
            ao = self._run_tdao(d, params)
            if ao is not None:
                c = c * ao[..., None]
        elif shader == "atmo":
            c = pp.atmo(c, d, self._world_rays(), self._t(self.sun_dir), self.far)
        elif shader == "cubemap_sky":
            faces = params.get("faces")
            faces = self._t(faces) if faces is not None else pp.default_cubemap(device=self.device)
            c = pp.cubemap_sky(c, d, self._world_rays(), faces, self.far)
        elif shader == "dof":
            c = pp.dof(c, d, params.get("focus_dist", 20.0), params.get("focus_range", 25.0),
                       far=self.far)
        elif shader == "taa":
            if self.history is not None and self.history.shape == c.shape:
                c = pp.taa(c, self.history, params.get("alpha", 0.15))
            self.history = c
        elif shader == "film_grain":
            key = prng.fold_in(prng.PRNGKey(7, self.device), self.frame_index)
            c = pp.film_grain(c, key, params.get("amount", 0.06))
        elif shader == "fsr_upscale":
            scale = params.get("scale", 1.5)
            oh, ow = int(round(self.height * scale)), int(round(self.width * scale))
            c = pp.fsr_upscale(c, oh, ow, params.get("sharpness", 0.4))
            self.depth = pp.resize_nearest(d, oh, ow)
            self.height, self.width = oh, ow
        # an unknown shader name leaves the colour as it is
        self.color = c

    def _run_decals(self, params):
        """Decals and curve decals (each bezier sampled into 8 boxes),
        projected onto the host framebuffer's depth on the device."""
        rows = decal_rows(self.rmod, self.runner.world)
        if rows is None:
            return
        slots, loc, lrot, he, tint = rows
        ep, er = self._wpos[:, slots].T, self._wrot[:, slots].T
        pos = ep + hm.quat_rotate(er, loc.T)
        rot = hm.quat_mul(er, lrot.T)
        out = pp.decal_pass(self._t(self.fb) / 255.0, self._t(self.zb), self.fov, self.aspect,
                            self._t(self.cam_pos), self._t(self.cam_rot), self._t(pos),
                            self._t(rot), self._t(he), self._t(tint),
                            alpha=params.get("alpha", 0.65), far=self.far)
        self.fb[:] = _host(out) * 255.0

    def _run_lights(self, params):
        """Clustered point-light shading (``clusters.fill_clusters`` and the
        light loop) on the host framebuffer, before the plugins."""
        from lumixengine_tpu_torch.renderer import clusters as _cls

        st = self.rmod.statics()
        if st.pl_slots.size == 0 or not np.any(st.pl_mask):
            return
        state = self.runner.state
        rs = state.modules["renderer"]
        cl = _cls.fill_clusters(state, self.rmod, cam_slot=self.cam_slot, statics=st)
        lw = self._wpos[:, np.maximum(st.pl_slots, 0)].T
        inv = hm.quat_conjugate(self.cam_rot)
        lv = hm.quat_rotate(np.broadcast_to(inv, (len(lw), 4)), lw - self.cam_pos)
        out = pp.deferred_lights(
            self._t(self.fb) / 255.0, self._t(self.zb), self.fov, self.aspect, self._t(lv),
            rs.pl_color.T, rs.pl_intensity, rs.pl_range, cl.lights, grid=_cls.GRID,
            near=float(rs.cam_near[self.cam_slot]), far_cluster=float(rs.cam_far[self.cam_slot]),
            far=self.far)
        self.fb[:] = np.clip(_host(out), 0.0, 4.0) * 255.0

    def _run_tdao(self, d, params):
        spheres = self._bound_scene()
        if spheres is None:
            return None
        ipos, irad = spheres
        mn = ipos.min(axis=0) - 1.0
        mx = ipos.max(axis=0) + 1.0
        inv = 1.0 / np.maximum(mx - mn, 1e-3)
        bmin, binv = self._t([mn[0], mn[2]]), self._t([inv[0], inv[2]])
        grid = pp.tdao_heightmap(self._t(ipos), self._t(irad), bmin, binv)
        return pp.tdao(d, grid, self._t(self.cam_pos), self._t(self.cam_rot), self.fov,
                       self.aspect, bmin, binv, params.get("strength", 0.7), far=self.far)

    def _bound_scene(self):
        """The visible instances' bounding spheres (pos [N, 3], radius [N])."""
        if self._scene_spheres is None:
            view = self.runner.prepare_view(self.cam_slot)
            n = min(int(view.visible_count), self.max_instances)
            if n == 0:
                return None
            ipos = _host(view.instance_pos).T[:n]
            models = _host(view.instance_model)[:n]
            scale = _host(view.instance_scale).T[:n]
            reg = self.rmod.system.bake()
            rad = reg.host_bounding_radius[np.maximum(models, 0)] * np.max(np.abs(scale), axis=-1)
            self._scene_spheres = (ipos.astype(np.float32), rad.astype(np.float32))
        return self._scene_spheres

    # -- readback -------------------------------------------------------------

    def finish(self) -> np.ndarray:
        """The presented uint8 [H, W, 3] (display-referred)."""
        if self.color is None:
            return np.clip(self.fb, 0, 255).astype(np.uint8)
        return np.clip(_host(self.color) * 255.0, 0, 255).astype(np.uint8)


def terrain_grid(tr: dict, max_grid: int):
    """Heightfield → entity-local grid mesh (verts f32 [V, 3], tris int32
    [T, 3]) decimated to at most max_grid² vertices, or None when under
    2 x 2."""
    hmap = tr["heights"]
    hgt, wid = hmap.shape
    step = max(1, int(np.ceil(max(hgt, wid) / max_grid)))
    sub = hmap[::step, ::step]
    sh, sw = sub.shape
    if sh < 2 or sw < 2:
        return None
    xs = np.arange(sw, dtype=np.float32) * (tr["xz_scale"] * step)
    zs = np.arange(sh, dtype=np.float32) * (tr["xz_scale"] * step)
    gx, gz = np.meshgrid(xs, zs)
    verts = np.stack([gx, sub * tr["y_scale"], gz], -1).reshape(-1, 3)
    idx = np.arange(sh * sw).reshape(sh, sw)
    q00, q10 = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    q01, q11 = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    tris = np.concatenate([np.stack([q00, q10, q11], -1),
                           np.stack([q00, q11, q01], -1)]).astype(np.int32)
    return verts.astype(np.float32), tris


def grass_blades(registry, tid: int, tr: dict, device, max_blades: int = 512):
    """[(terrain-local blade roots f32 [N, 3], blade height)] per grass type:
    ``terrain.scatter_grass`` from threefry ``PRNGKey(17 + gi)``."""
    from lumixengine_tpu_torch.renderer import terrain as T

    bank = registry.bank(device)
    hgt, wid = tr["heights"].shape
    ext = (wid * tr["xz_scale"], hgt * tr["xz_scale"])
    out = []
    for gi, gt in enumerate(tr["grass_types"]):
        pos, _yaw, mask = T.scatter_grass(bank, tid, float(gt.get("density", 0.2)), ext,
                                          prng.PRNGKey(17 + gi, device),
                                          max_instances=max_blades)
        p = _host(pos).T[_host(mask)][:max_blades]
        if len(p):
            out.append((p, float(gt.get("height", 0.5))))
    return out


def blade_mesh(p: np.ndarray, h: float, r: float = 0.08):
    """One triangle a blade root p [N, 3]: base ±r in x, tip h up."""
    n = len(p)
    verts = np.concatenate([p + [-r, 0, 0], p + [r, 0, 0], p + [0, h, 0]])
    tris = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], -1).astype(np.int32)
    return verts, tris


def decal_rows(rmod, world):
    """The decals' static rows: (entity slots int64 [D], local offsets f32
    [3, D], local rotations [4, D], half extents [D, 3], tints [D, 3]); each
    curve decal's quadratic bezier (p0 → the entity's origin → p2 in its XZ
    plane) sampled into 8 boxes. None without decals."""
    slots, loc, lrot, he, tint = [], [], [], [], []
    pal = raster._PALETTE
    for slot in range(rmod.decals.capacity):
        e = int(rmod.decals.entity[slot])
        if e < 0:
            continue
        slots.append(world.slot(e))
        loc.append(np.zeros(3, np.float32))
        lrot.append(np.array([0, 0, 0, 1], np.float32))
        he.append(np.asarray(rmod.decals.data["half_extents"][slot]))
        tint.append(pal[int(rmod.decals.data["material"][slot]) % len(pal)] / 255.0)
    for slot in range(rmod.curve_decals.capacity):
        e = int(rmod.curve_decals.entity[slot])
        if e < 0:
            continue
        data = rmod.curve_decals.data
        bhe = np.asarray(data["half_extents"][slot])
        p0, p2 = np.asarray(data["bezier_p0"][slot]), np.asarray(data["bezier_p2"][slot])
        t = pal[int(data["material"][slot]) % len(pal)] / 255.0
        nseg = 8
        ts = np.linspace(0.0, 1.0, nseg + 1)
        bz = ((1 - ts) ** 2)[:, None] * p0[None] + (ts ** 2)[:, None] * p2[None]
        for i in range(nseg):
            a, b = bz[i], bz[i + 1]
            mid, d = (a + b) * 0.5, b - a
            ln = float(np.hypot(d[0], d[1]))
            yaw = float(np.arctan2(d[0], d[1]))
            slots.append(world.slot(e))
            loc.append(np.array([mid[0], 0.0, mid[1]], np.float32))
            lrot.append(np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)], np.float32))
            he.append(np.array([bhe[0], bhe[1], ln / 2 + 0.05], np.float32))
            tint.append(t)
    if not slots:
        return None
    return (np.asarray(slots, np.int64), np.stack(loc).T.astype(np.float32),
            np.stack(lrot).T.astype(np.float32), np.stack(he).astype(np.float32),
            np.stack(tint).astype(np.float32))


def compose_gui(buf: np.ndarray, runner, width: int, height: int) -> np.ndarray:
    """The GUI overlay onto a float [H, W, 3] 0-255 buffer in place: rect
    fills, font-atlas glyph blits and input carets, canvas coordinates
    scaled to the framebuffer."""
    gui = runner.world.modules.get("gui")
    if gui is None:
        return buf
    cw, ch = getattr(gui, "canvas_size", (width, height))
    sx, sy = width / float(cw), height / float(ch)
    for it in gui.draw_list(runner.state):
        r = it["rect"]
        x0, y0 = int(max(r[0] * sx, 0)), int(max(r[1] * sy, 0))
        x1, y1 = min(int(r[2] * sx), width), min(int(r[3] * sy), height)
        if x0 < x1 and y0 < y1 and "color" in it:
            c = np.asarray(it["color"][:3], np.float32) * 255.0
            a = it["color"][3] if len(it["color"]) > 3 else 0.6
            buf[y0:y1, x0:x1] = buf[y0:y1, x0:x1] * (1 - a) + c[None, None] * a
        for g in it.get("glyphs", ()):
            _blit_glyph_np(gui, it, g, sx, sy, buf, width, height)
        if "caret" in it:
            cx0, cy0, cx1, cy1 = it["caret"]
            x0 = int(max(cx0 * sx, 0))
            x1 = min(int(max(cx1 * sx, x0 + 1)), width)
            y0, y1 = int(max(cy0 * sy, 0)), min(int(cy1 * sy), height)
            if x0 < x1 and y0 < y1:
                buf[y0:y1, x0:x1] = 235.0
    return buf


def _blit_glyph_np(gui, item, g, sx, sy, buf, width, height):
    """g = (x0, y0, x1, y1, u0, v0, u1, v1) in canvas pixels; the atlas crop
    is nearest-resampled to the scaled quad."""
    font = gui._font(item.get("font_size", 24))
    gx0, gy0, gx1, gy1, u0, v0, u1, v1 = g
    x0, y0 = int(max(gx0 * sx, 0)), int(max(gy0 * sy, 0))
    x1, y1 = min(int(round(gx1 * sx)), width), min(int(round(gy1 * sy)), height)
    if x0 >= x1 or y0 >= y1 or v1 <= v0 or u1 <= u0:
        return
    src = font.atlas[v0:v1, u0:u1].astype(np.float32) / 255.0
    h, w = y1 - y0, x1 - x0
    ri = (np.arange(h) * (src.shape[0] / h)).astype(np.int32)
    ci = (np.arange(w) * (src.shape[1] / w)).astype(np.int32)
    a = src[ri][:, ci][..., None]
    buf[y0:y1, x0:x1] = buf[y0:y1, x0:x1] * (1 - a) + 235.0 * a


def skin_map(world) -> dict:
    """World slot → palette pool column (animables first, then animators
    after animables.capacity)."""
    out = {}
    amod = world.modules.get("animation")
    if amod is not None:
        st = amod.statics()
        a1 = amod.animables.capacity
        for g in st.an_groups:
            for c, s in zip(g["cols"], g["entity_slots"]):
                out[int(s)] = int(c)
        for g in st.at_groups:
            for c, s in zip(g["cols"], g["entity_slots"]):
                out[int(s)] = int(a1 + c)
    return out


def skin_points_dq_np(pal, points, bones4, weights) -> np.ndarray:
    """Host dual-quaternion skinning: pal [8, B] (real xyzw | dual), points
    [V, 3], bones4 [V, 4], weights [V, 4] → posed points [V, 3]; each bone
    flipped into bone 0's hemisphere first."""
    d = np.sum(pal[:4] * pal[:4, 0:1], axis=0)
    pal = pal * np.where(d < 0.0, -1.0, 1.0)[None]
    q = pal[:, bones4]                                # [8, V, 4]
    b = np.sum(q * weights[None], axis=-1)            # [8, V]
    n = np.linalg.norm(b[:4], axis=0)
    b = b / np.maximum(n, 1e-9)[None]
    qr, qd = b[:4].T, b[4:].T
    t = 2.0 * hm.quat_mul(qd, hm.quat_conjugate(qr))[:, :3]
    return hm.quat_rotate(qr, np.asarray(points, np.float32)) + t


def particle_rows(em):
    """(pos_row, col_row, col_width, size_row) of an emitter's outputs by
    name: a 3-wide output named *pos* (else the first 3-wide one), the first
    3+-wide *color*, the first 1-wide *scale*/*size*; -1 for none. None
    without a position."""
    outs = getattr(em, "outs", None)
    if not outs:
        return None
    rows, row, first3 = {}, 0, None
    for name, w in outs:
        rows[name.lower()] = (row, w)
        if w >= 3 and first3 is None:
            first3 = row
        row += w
    pos_row = first3
    for name, (r, w) in rows.items():
        if "pos" in name and w >= 3:
            pos_row = r
    if pos_row is None:
        return None
    col_row, col_w, size_row = -1, 0, -1
    for name, (r, w) in rows.items():
        if "color" in name and w >= 3 and col_row < 0:
            col_row, col_w = r, w
        if ("scale" in name or "size" in name) and w == 1 and size_row < 0:
            size_row = r
    return pos_row, col_row, col_w, size_row


def _particle_outputs(est, em):
    """(positions [cap, 3], colours [cap, 3] or None, sizes [cap] or None)."""
    rows = particle_rows(em)
    if rows is None:
        return None, None, None
    pos_row, col_row, col_w, size_row = rows
    arr = _host(est.outs)
    pos = arr[pos_row:pos_row + 3].T.astype(np.float32)
    col = None
    if col_row >= 0:
        col = np.clip(arr[col_row:col_row + 3].T.astype(np.float32), 0.0, 4.0)
        if col_w >= 4:
            col = col * np.clip(arr[col_row + 3][:, None], 0.0, 1.0)
    size = np.abs(arr[size_row].astype(np.float32)) if size_row >= 0 else None
    return pos, col, size


def _project_np(points, cam_pos, cam_rot, fov_y, aspect, width, height):
    inv = hm.quat_conjugate(cam_rot)
    local = hm.quat_rotate(np.broadcast_to(inv, (len(points), 4)), points - cam_pos)
    depth = -local[:, 2]
    f = 1.0 / np.tan(fov_y * 0.5)
    safe = np.maximum(depth, 1e-3)
    sx = ((local[:, 0] * f / aspect) / safe * 0.5 + 0.5) * width
    sy = (1.0 - ((local[:, 1] * f) / safe * 0.5 + 0.5)) * height
    return np.stack([sx, sy], -1), depth


def render_frame(runner, path: Optional[str] = None, cam_slot: int = 0, width: int = 480,
                 height: int = 270, backend: Optional[SoftwareGpuBackend] = None,
                 max_instances: int = 2048, debug_nav: bool = False):
    """Record the frame's DrawStream (with the registered RenderPlugins) and
    replay it through the software backend → (uint8 image, backend); a PNG
    at `path` when given. Pass the previous frame's backend to keep the TAA
    history."""
    from lumixengine_tpu_torch.renderer.draw_stream import record_frame
    from lumixengine_tpu_torch.renderer.texture import write_png

    rmod = runner.world.modules["renderer"]
    view = runner.prepare_view(cam_slot)
    prev_hist = backend.history if backend is not None else None
    be = SoftwareGpuBackend(runner, cam_slot, width, height, max_instances)
    be.history = prev_hist
    record_frame(view, runner.state.modules["renderer"], rmod).replay(be)
    if debug_nav:
        be.draw_nav_debug()
    img = be.finish()
    if path:
        write_png(path, img)
    return img, be
