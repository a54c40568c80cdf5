"""The plain reference of the frame: what one frame of a world farm computes,
written layer by layer from the engine's semantics, straightforwardly and
apart from the program's code.

A state is a flat dict of tensors batched over worlds [W, ...], named as
the program names its state's fields (``local.pos``,
``modules.physics.lam_n``, ...) so that the two meet by name; transforms
are [W, 3 | 4, N] with the entity slots in hierarchy-level order. The
frame, in the engine's phase order:

1. the renderer keeps each model instance's world transform of the frame
   before (``prev_pos``, ``prev_rot``);
2. animators: the locomotion controller's three clocks, the speed blend
   of idle, walk and run, the blended pose, its model-space pose by the
   skeleton, the dual-quaternion palette, and root motion onto the
   character's transform;
3. rigid bodies: gravity and damping, the ground's and the overlapping
   pairs' contacts (the pairs whose boxes overlap, compacted into a fixed
   budget), the projected Jacobi contact solve warm-started from the last
   frame's impulses, integration, the position projection, sleeping;
4. particles: the emitter script's update, kills, timed emission into the
   dead slots from the counter-based generator, and its outputs;
5. animables: each clip's clock, its sampled pose, model-space pose and
   palette;
6. the bodies' poses written to their entities;
7. the hierarchy: each entity's world transform, parent before child;
8. the cull pass: camera 0's frustum, the model instances' spheres, the LOD
   by distance, the point lights; frame and time advance.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference import ops
from benchmark.reference.recipe import LOCOMOTION_POINTS, MODELS, SHAPE_BOX, STORM, Scene

V = -2                    # the component axis of [W, C, N] tensors
P_AX = -3                 # the component axis of pose tensors [W, C, B, A]
GRAVITY = (0.0, -9.81, 0.0)
DAMPING = 0.05
GROUND_FRICTION = 0.6
GROUND_SLOTS = 4          # deepest points of a body on the ground plane
PAIR_POINTS = 4           # deepest points of a touching pair
PAIR_MARGIN = 0.05        # a pair is a candidate while its boxes overlap within this margin
ITERATIONS, POSITION_ITERATIONS = 10, 3
SLOP, RELAX, PROJ_RELAX = 0.005, 0.75, 0.8
SLEEP_V, SLEEP_W, SLEEP_FRAMES = 0.03, 0.05, 30
RESTITUTION = 0.0         # every body of these scenes, and the ground
MAX_DT = 1.0 / 20.0
LODS = 4
EMITTER = "storm"
FIELD = {"an_time": "modules.animation.an_time", "clocks": "modules.animation.ctrl_clocks",
         "pose_pos": "modules.animation.pose_pos", "pose_rot": "modules.animation.pose_rot",
         "palette": "modules.animation.palette", "prev_pos": "modules.renderer.prev_pos",
         "prev_rot": "modules.renderer.prev_rot", "visible": "modules.renderer.mi_visible",
         "lod": "modules.renderer.mi_lod", "lights": "modules.renderer.pl_visible"}


def _t(a, device, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


class Model:
    """The scene's layout and constants on `device`, and its frame."""

    def __init__(self, scene: Scene, device):
        self.scene, self.device = scene, torch.device(device)
        dev = self.device
        n = scene.capacity
        level = np.zeros(n, np.int64)
        for e in range(n):
            p = scene.parent[e]
            while p >= 0:
                level[e] += 1
                p = scene.parent[p]
        order = np.argsort(level, kind="stable")              # slot -> entity
        self.slot_of = np.empty(n, np.int64)
        self.slot_of[order] = np.arange(n)
        self.order = order
        slot_parent = np.where(scene.parent[order] >= 0,
                               self.slot_of[np.maximum(scene.parent[order], 0)], -1)
        self.levels = []
        for d in range(1, int(level.max()) + 1):
            kids = np.nonzero(level[order] == d)[0]
            self.levels.append((_t(kids, dev), _t(slot_parent[kids], dev)))
        self.alive = _t(scene.alive[order], dev)

        def slots(entities):
            return self.slot_of[np.asarray(entities, np.int64)] if len(entities) else \
                np.zeros(0, np.int64)

        # model instances, the camera, the point lights
        k = scene.mi_capacity
        mi_slots = np.zeros(k, np.int64)
        mi_model = np.zeros(k, np.int64)
        mi_mask = np.zeros(k, bool)
        mi_slots[:len(scene.mi)] = slots([e for e, _ in scene.mi])
        mi_model[:len(scene.mi)] = [m for _, m in scene.mi]
        mi_mask[:len(scene.mi)] = True
        radius = np.array([r for r, _ in MODELS.values()], np.float32)
        lod = np.array([d for _, d in MODELS.values()], np.float32)       # [M, 4]
        self.mi_index, self.mi_mask = _t(mi_slots, dev), _t(mi_mask, dev)
        self.mi_radius = _t(np.where(mi_mask, radius[mi_model], 1.0).astype(np.float32), dev)
        self.lod_dist = _t(lod[mi_model].T, dev, torch.float32)            # [4, K]
        cam, fov, near, far = scene.camera
        self.cam_slot = int(self.slot_of[cam])
        self.fov, self.near, self.far = fov, near, far
        self.aspect = np.float32(16.0 / 9.0)
        nl = scene.light_capacity
        pl = np.zeros(nl, np.int64)
        pl_mask = np.zeros(nl, bool)
        pl_range = np.full(nl, 10.0, np.float32)
        pl[:len(scene.lights)] = slots([e for e, _ in scene.lights])
        pl_mask[:len(scene.lights)] = True
        pl_range[:len(scene.lights)] = [r for _, r in scene.lights]
        self.pl_index, self.pl_mask, self.pl_range = _t(pl, dev), _t(pl_mask, dev), _t(pl_range, dev)

        self._animation(scene, slots)
        self._bodies(scene, slots)
        self.emitter = None
        if scene.emitter is not None:
            e, cap = scene.emitter
            self.emitter = SimpleNamespace(
                prefix=f"modules.renderer.particles.pe{e}.{EMITTER}.", cap=cap,
                lo=_t(np.array(STORM["spawn_lo"], np.float32), dev),
                hi=_t(np.array(STORM["spawn_hi"], np.float32), dev))

    # -- constants of each layer ----------------------------------------------------

    def _animation(self, scene: Scene, slots) -> None:
        dev = self.device
        sk = scene.skeleton
        self.bone_parent = [int(p) for p in sk.parent]
        ibp, ibr = sk.inverse_bind()
        self.ibp, self.ibr = _t(ibp.T, dev)[..., None], _t(ibr.T, dev)[..., None]  # [3|4, B, 1]
        clips = scene.clips
        frames = [c.frames for c in clips]
        self.clip_offset = np.concatenate([[0], np.cumsum(frames)[:-1]]).astype(np.int64)
        self.clip_frames, self.clip_fps = np.array(frames), np.array([c.fps for c in clips], np.float32)
        self.clip_length = np.array([c.length for c in clips], np.float32)
        # the frames of every clip, [frame, 7 * B]: positions then rotations of each bone;
        # the root track [frame, 7]: the root bone's x-z travel against frame 0 and no turn
        table = np.concatenate([np.concatenate([c.pos.transpose(0, 2, 1).reshape(c.frames, -1),
                                                c.rot.transpose(0, 2, 1).reshape(c.frames, -1)],
                                               axis=1) for c in clips])
        root = np.zeros((sum(frames), 7), np.float32)
        root[:, 6] = 1.0
        for i, c in enumerate(clips):
            o = self.clip_offset[i]
            if c.flags:
                d = c.pos[:, 0, :] - c.pos[0, 0, :]
                root[o:o + c.frames, 0] = d[:, 0]
                root[o:o + c.frames, 2] = d[:, 2]
        self.table, self.root = _t(table, dev), _t(root, dev)
        self.clip_flags = [c.flags for c in clips]
        self.root_end = [_t(root[self.clip_offset[i] + c.frames - 1], dev)
                         for i, c in enumerate(clips)]
        a1, a2 = scene.animable_capacity, scene.animator_capacity
        self.a1, self.a2 = a1, a2
        n1, n2 = len(scene.animables), len(scene.animators)
        self.an_cols = _t(np.arange(n1), dev)
        self.an_slots = _t(slots([e for e, _, _ in scene.animables]), dev)
        self.an_clip = _t(np.array([c for _, c, _ in scene.animables], np.int64), dev)
        self.at_cols = _t(np.arange(n2), dev)
        self.at_slots = _t(slots([e for e, _ in scene.animators]), dev)
        start = np.zeros(a1, np.float32)
        start[:n1] = [t for _, _, t in scene.animables]
        inputs = np.zeros((scene.controller_inputs, a2), np.float32)
        inputs[0, :n2] = [s for _, s in scene.animators]
        self.an_start, self.inputs = _t(start, dev), _t(inputs, dev)

    def _bodies(self, scene: Scene, slots) -> None:
        dev = self.device
        nb = scene.body_capacity
        self.nb = nb
        if not nb:
            return
        shape = np.zeros(nb, np.int64)
        radius = np.full(nb, 0.5, np.float32)
        he = np.full((3, nb), 0.5, np.float32)
        fric = np.full(nb, 0.5, np.float32)
        ent = [b[0] for b in scene.bodies]
        for i, (_e, sh, r, h, f) in enumerate(scene.bodies):
            shape[i], radius[i], he[:, i], fric[i] = sh, r, h, f
        used = np.zeros(nb, bool)
        used[:len(ent)] = True
        self.body_slots = _t(slots(ent), dev)
        self.body_cols = _t(np.arange(len(ent)), dev)
        self.dyn = _t(used, dev)
        mass = np.ones(nb, np.float32)
        inertia = np.zeros((3, nb), np.float32)
        for a in range(3):
            b, c = (a + 1) % 3, (a + 2) % 3
            box = mass / 12.0 * ((2 * he[b]) ** 2 + (2 * he[c]) ** 2)
            ball = 0.4 * mass * radius ** 2
            inertia[a] = np.where(used, 1.0 / np.maximum(np.where(shape == SHAPE_BOX, box, ball),
                                                         1e-9), 0.0)
        self.shape, self.radius, self.he = _t(shape, dev), _t(radius, dev), _t(he, dev)
        self.is_box = self.shape == SHAPE_BOX
        self.inv_mass = _t(np.where(used, 1.0 / mass, 0.0).astype(np.float32), dev)
        self.inv_inertia = _t(inertia, dev)
        self.friction = _t(fric, dev)
        self.ground_friction = torch.sqrt(self.friction * np.float32(GROUND_FRICTION))
        ia, ib = np.triu_indices(nb, k=1)
        keep = used[ia] & used[ib]
        self.pair_a, self.pair_b = _t(ia[keep], dev), _t(ib[keep], dev)
        self.budget = int(min(max(128, 6 * int(used.sum())), len(self.pair_a)))
        self.gravity = _t(np.array(GRAVITY, np.float32)[:, None], dev)
        signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                         np.float32).T
        self.corner_signs = _t(signs, dev)                     # [3, 8]

    @property
    def names(self):
        """The state's fields, as the start gives them: what a frame reads and writes."""
        if not hasattr(self, "_names"):
            self._names = list(self.start(1, torch.Generator(self.device).manual_seed(0)))
        return self._names

    # -- the start ------------------------------------------------------------------

    def start(self, worlds: int, generator: torch.Generator, rows=None) -> dict:
        """Every world as the scene is built, then the benchmark's per-world
        noise from `generator`, in this order: local positions N(0, 0.01^2),
        the bodies' sleep counters staggered up to 15 frames, their
        velocities and angular velocities N(0, 0.05^2). With `rows`, only
        those worlds (the noise is drawn for all `worlds` all the same)."""
        sc, dev = self.scene, self.device
        one = {}
        o = self.order
        one["local.pos"] = _t(sc.pos[o].T, dev)
        one["local.rot"] = _t(sc.rot[o].T, dev)
        one["local.scale"] = _t(sc.scale[o].T, dev)
        one.update({f"world.{k}": v for k, v in
                    self.propagate({k: one[f"local.{k}"][None] for k in ("pos", "rot", "scale")})
                    .items()})
        one["world.pos"], one["world.rot"], one["world.scale"] = (
            one["world.pos"][0], one["world.rot"][0], one["world.scale"][0])
        one["frame"] = torch.zeros((), dtype=torch.int32, device=dev)
        one["time"] = torch.zeros((), dtype=torch.float32, device=dev)
        k = sc.mi_capacity
        one[FIELD["prev_pos"]] = torch.zeros((3, k), device=dev)
        one[FIELD["prev_rot"]] = identity_quats(k, dev)
        one[FIELD["visible"]] = torch.zeros(k, dtype=torch.bool, device=dev)
        one[FIELD["lod"]] = torch.zeros(k, dtype=torch.int32, device=dev)
        one[FIELD["lights"]] = torch.zeros(sc.light_capacity, dtype=torch.bool, device=dev)
        b, p = len(self.bone_parent), self.a1 + self.a2
        one[FIELD["an_time"]] = self.an_start.clone()
        one[FIELD["clocks"]] = torch.zeros((len(self.scene.clips), self.a2), device=dev)
        one[FIELD["pose_pos"]] = torch.zeros((3, b, p), device=dev)
        one[FIELD["pose_rot"]] = identity_quats((b, p), dev)
        pal = torch.zeros((8, b, p), device=dev)
        pal[3] = 1.0
        one[FIELD["palette"]] = pal
        if self.nb:
            pos = np.zeros((3, self.nb), np.float32)
            rot = np.zeros((4, self.nb), np.float32)
            rot[3] = 1.0
            for i, body in enumerate(sc.bodies):
                pos[:, i] = sc.global_transform(body[0])[0]
                rot[:, i] = sc.global_transform(body[0])[1]
            c = GROUND_SLOTS * self.nb + PAIR_POINTS * self.budget
            ph = "modules.physics."
            one.update({ph + "pos": _t(pos, dev), ph + "rot": _t(rot, dev),
                        ph + "vel": torch.zeros((3, self.nb), device=dev),
                        ph + "angvel": torch.zeros((3, self.nb), device=dev),
                        ph + "sleep": torch.zeros(self.nb, dtype=torch.int32, device=dev),
                        ph + "pair_key": torch.full((self.budget,), -1, dtype=torch.int32,
                                                    device=dev)})
            one.update({ph + f: torch.zeros(c, device=dev) for f in ("lam_n", "lam_t1", "lam_t2")})
        if self.emitter is not None:
            em = self.emitter
            one[em.prefix + "channels"] = torch.zeros((7, em.cap), device=dev)
            one[em.prefix + "outs"] = torch.zeros((8, em.cap), device=dev)
            one[em.prefix + "alive"] = torch.zeros(em.cap, dtype=torch.bool, device=dev)
            one[em.prefix + "emit_acc"] = torch.zeros((), device=dev)
        rows = torch.arange(worlds, device=dev) if rows is None else rows.to(dev)
        state = {k: v.unsqueeze(0).expand((len(rows),) + v.shape).clone() for k, v in one.items()}

        def noise(shape):
            draw = torch.randn((worlds,) + shape[1:], generator=generator, device=generator.device)
            return draw.to(dev).index_select(0, rows)

        state["local.pos"] = state["local.pos"] + noise(state["local.pos"].shape) * 0.01
        if self.nb:
            ph = "modules.physics."
            stag = torch.randint(0, 16, (worlds, self.nb), generator=generator,
                                 device=generator.device).to(dev, torch.int32).index_select(0, rows)
            state[ph + "sleep"] = torch.maximum(state[ph + "sleep"], stag)
            state[ph + "vel"] = state[ph + "vel"] + noise(state[ph + "vel"].shape) * 0.05
            state[ph + "angvel"] = state[ph + "angvel"] + noise(state[ph + "angvel"].shape) * 0.05
        return state

    # -- the frame ------------------------------------------------------------------

    def frame(self, s: dict, dt: float) -> dict:
        """The state after one frame of dt seconds (a new dict; `s` is read)."""
        dt = torch.tensor(dt, dtype=torch.float32, device=self.device)
        s = {k: s[k] for k in self.names}
        s[FIELD["prev_pos"]] = s["world.pos"].index_select(-1, self.mi_index)
        s[FIELD["prev_rot"]] = s["world.rot"].index_select(-1, self.mi_index)
        if len(self.scene.animators):
            self.animators(s, dt)
        if self.nb:
            self.bodies(s, dt)
        if self.emitter is not None:
            self.particles(s, dt)
        if len(self.scene.animables):
            self.animables(s, dt)
        if self.nb:
            ph = "modules.physics."
            for k in ("pos", "rot"):
                s[f"local.{k}"] = s[f"local.{k}"].index_copy(
                    -1, self.body_slots, s[ph + k].index_select(-1, self.body_cols))
        s.update({f"world.{k}": v for k, v in self.propagate(
            {k: s[f"local.{k}"] for k in ("pos", "rot", "scale")}).items()})
        self.cull(s)
        s["frame"] = s["frame"] + 1
        s["time"] = s["time"] + dt
        return s

    def propagate(self, local: dict) -> dict:
        """World transforms: a root's is its local one; a child's is its
        parent's world transform composed with its local one, level by level."""
        pos, rot, scale = local["pos"], local["rot"], local["scale"]
        for kids, parents in self.levels:
            pp, pr, ps = (x.index_select(-1, parents) for x in (pos, rot, scale))
            lp, lr, ls = (x.index_select(-1, kids) for x in (local["pos"], local["rot"],
                                                             local["scale"]))
            pos = pos.index_copy(-1, kids, pp + ops.qrot(pr, lp * ps, V))
            rot = rot.index_copy(-1, kids, ops.qmul(pr, lr, V))
            scale = scale.index_copy(-1, kids, ps * ls)
        return {"pos": pos, "rot": rot, "scale": scale}

    # -- animation ------------------------------------------------------------------

    def sample(self, track: torch.Tensor, t: torch.Tensor, clip) -> torch.Tensor:
        """A track ([frames, R]) at times t [W, A] of clips `clip` (an int or
        [A]), looping: the two frames around t lerped; rotations unit again
        by the caller -> [W, R, A]."""
        cl = torch.as_tensor(clip, device=self.device)
        off = _t(self.clip_offset, self.device)[cl]
        nf = _t(self.clip_frames, self.device)[cl]
        t = torch.remainder(t, _t(self.clip_length, self.device)[cl])
        ff = t * _t(self.clip_fps, self.device)[cl]
        f0 = torch.minimum(torch.clamp_min(torch.floor(ff).to(torch.int64), 0), nf - 1)
        f1 = torch.minimum(f0 + 1, nf - 1)
        a = ff - f0.to(torch.float32)
        w0, w1 = (1.0 - a), a
        out = track[off + f0] * w0.unsqueeze(-1) + track[off + f1] * w1.unsqueeze(-1)
        return out.transpose(-1, -2)

    def pose(self, t, clip):
        """The clip's local bone pose at t: (pos [W, 3, B, A], rot [W, 4, B, A])."""
        out = self.sample(self.table, t, clip)
        out = out.reshape(out.shape[:-2] + (7, len(self.bone_parent), out.shape[-1]))
        return out[..., 0:3, :, :], ops.normalized(out[..., 3:7, :, :], P_AX)

    def root_motion(self, t, clip):
        out = self.sample(self.root, t, clip)
        return out[..., 0:3, :], ops.normalized(out[..., 3:7, :], V)

    def model_space(self, pos, rot):
        """Each bone's model-space transform, parents first (bones are rigid)."""
        ap, ar = list(pos.unbind(-2)), list(rot.unbind(-2))
        for b, p in enumerate(self.bone_parent):
            if p >= 0:
                ap[b] = ap[p] + ops.qrot(ar[p], ap[b], V)
                ar[b] = ops.qmul(ar[p], ar[b], V)
        return torch.stack(ap, dim=-2), torch.stack(ar, dim=-2)

    def palette(self, apos, arot):
        """Dual quaternions of model-space pose times inverse bind [W, 8, B, A]."""
        pos = apos + ops.qrot(arot, self.ibp, P_AX)
        rot = ops.qmul(arot, self.ibr, P_AX)
        pq = torch.cat([pos, torch.zeros_like(pos[..., :1, :, :])], dim=P_AX)
        return torch.cat([rot, 0.5 * ops.qmul(pq, rot, P_AX)], dim=P_AX)

    def store_pose(self, s, cols, apos, arot) -> None:
        s[FIELD["pose_pos"]] = s[FIELD["pose_pos"]].index_copy(-1, cols, apos)
        s[FIELD["pose_rot"]] = s[FIELD["pose_rot"]].index_copy(-1, cols, arot)
        s[FIELD["palette"]] = s[FIELD["palette"]].index_copy(-1, cols, self.palette(apos, arot))

    def animators(self, s, dt) -> None:
        """The locomotion controller: three looping clocks; hat weights of
        the clamped speed over the points; the weighted running blend of
        the three sampled poses and of their root-motion deltas."""
        cols = self.at_cols
        clocks = s[FIELD["clocks"]].index_select(-1, cols)              # [W, 3, A]
        speed = self.inputs[0].index_select(-1, cols)
        pts = LOCOMOTION_POINTS
        x = torch.clamp(speed, pts[0], pts[-1]).expand(clocks.shape[:1] + speed.shape)
        weights = []
        for i, p in enumerate(pts):
            if i == 0:
                w = torch.where(x <= p, 1.0, torch.clamp((pts[1] - x) / (pts[1] - p), 0.0, 1.0))
            elif i == len(pts) - 1:
                w = torch.where(x <= p, torch.clamp((x - pts[i - 1]) / (p - pts[i - 1]), 0.0, 1.0),
                                0.0)
            else:
                w = torch.where(x <= p, torch.clamp((x - pts[i - 1]) / (p - pts[i - 1]), 0.0, 1.0),
                                torch.clamp((pts[i + 1] - x) / (pts[i + 1] - p), 0.0, 1.0))
            weights.append(w)
        new = [torch.remainder(clocks[:, i] + dt, float(self.clip_length[i]))
               for i in range(len(pts))]
        acc_p = acc_r = cum = rdp = rdr = moved = None
        ident = torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.device)[:, None]
        for i, w in enumerate(weights):
            p_s, r_s = self.pose(new[i], i)
            rm = (self.clip_flags[i] != 0) & (w > 1e-6)
            dp, dr = self.root_delta(i, clocks[:, i], new[i])
            dp = dp * rm.unsqueeze(-2)
            dr = torch.where(rm.unsqueeze(-2), dr, ident)
            moved = rm if moved is None else moved | rm
            if acc_p is None:
                acc_p, acc_r, cum, rdp, rdr = p_s, r_s, torch.clamp_min(w, 1e-6), dp, dr
                continue
            total = cum + w
            f = w / torch.clamp_min(total, 1e-6)
            fb = f[:, None, None, :]
            acc_p = acc_p + (p_s - acc_p) * fb
            acc_r = ops.nlerp(acc_r, r_s, fb, P_AX)
            rdp = rdp + (dp - rdp) * f.unsqueeze(-2)
            rdr = ops.nlerp(rdr, dr, f.unsqueeze(-2), V)
            cum = total
        s[FIELD["clocks"]] = s[FIELD["clocks"]].index_copy(-1, cols, torch.stack(new, dim=-2))
        apos, arot = self.model_space(acc_p, acc_r)
        self.store_pose(s, self.a1 + cols, apos, arot)
        lp = s["local.pos"].index_select(-1, self.at_slots)
        lr = s["local.rot"].index_select(-1, self.at_slots)
        m = moved.unsqueeze(-2)
        np_ = torch.where(m, lp + ops.qrot(lr, rdp, V), lp)
        nr = torch.where(m, ops.normalized(ops.qmul(lr, rdr, V), V), lr)
        s["local.pos"] = s["local.pos"].index_copy(-1, self.at_slots, np_)
        s["local.rot"] = s["local.rot"].index_copy(-1, self.at_slots, nr)

    def root_delta(self, clip: int, before, after):
        """The root's motion from clock `before` to `after` in the frame of
        the root at `before`; when the clock wrapped, to the clip's end and
        on from its start."""
        pa, ra = self.root_motion(after, clip)
        pb, rb = self.root_motion(before, clip)
        inv = ops.qconj(rb, V)
        d_p = ops.qrot(inv, pa - pb, V)
        d_r = ops.qmul(inv, ra, V)
        end = self.root_end[clip][:, None]
        e_p = ops.qrot(inv, end[:3] - pb, V)
        e_r = ops.qmul(inv, end[3:].expand_as(rb), V)
        w_p = e_p + ops.qrot(e_r, pa, V)
        w_r = ops.qmul(e_r, ra, V)
        wrapped = (after < before).unsqueeze(-2)
        return torch.where(wrapped, w_p, d_p), torch.where(wrapped, w_r, d_r)

    def animables(self, s, dt) -> None:
        cols = self.an_cols
        t = torch.remainder(s[FIELD["an_time"]].index_select(-1, cols) + dt * 1.0,
                            _t(self.clip_length, self.device)[self.an_clip])
        s[FIELD["an_time"]] = s[FIELD["an_time"]].index_copy(-1, cols, t)
        p, r = self.pose(t, self.an_clip)
        apos, arot = self.model_space(p, r)
        self.store_pose(s, cols, apos, arot)

    # -- rigid bodies ---------------------------------------------------------------

    def corners(self, pos, rot, he):
        """Box corners [W, 3, 8, n] of boxes pos, rot [W, 3|4, n], he [3, n]."""
        local = he[..., :, None, :] * self.corner_signs[:, :, None]
        return pos[..., :, None, :] + ops.qrot(rot[..., :, None, :], local, P_AX)

    def ground_contacts(self, pos, rot):
        """Each body's deepest points under the plane y = 0: a box its four
        deepest corners, a sphere its lowest point (slot 0). [k, NB] slots."""
        c = self.corners(pos, rot, self.he)
        depth, idx = torch.sort(-c[..., 1, :, :].transpose(-1, -2), dim=-1, descending=True,
                                stable=True)
        idx = idx[..., :GROUND_SLOTS].transpose(-1, -2)                 # [W, k, NB]
        box_pt = torch.gather(c, -2, idx.unsqueeze(-3).expand(c.shape[:-3] + (3,) + idx.shape[-2:]))
        box_d = depth[..., :GROUND_SLOTS].transpose(-1, -2)
        low = pos.clone()
        low[..., 1, :] = pos[..., 1, :] - self.radius
        first = (torch.arange(GROUND_SLOTS, device=self.device) == 0)[:, None]
        ball_pt = torch.where(first, low[..., :, None, :], 0.0)
        ball_d = torch.where(first, (0.0 - low[..., 1, :])[..., None, :], -1.0)
        pt = torch.where(self.is_box, box_pt, ball_pt)
        d = torch.where(self.is_box, box_d, ball_d)
        n = torch.zeros_like(pt)
        n[..., 1, :, :] = -1.0
        flat = lambda x: x.flatten(-2)  # noqa: E731
        a = torch.arange(self.nb, device=self.device).repeat(GROUND_SLOTS)
        return SimpleNamespace(a=a, b=torch.full_like(a, -1), point=flat(pt), normal=flat(n),
                               depth=flat(d), active=(flat(d) > 0.0) & self.dyn[a],
                               friction=self.ground_friction[a])

    def candidates(self, pos, rot):
        """The pairs whose bounding boxes overlap within the margin, first in
        pair order, then the others, cut at the budget -> (a, b [W, budget],
        valid)."""
        axes = torch.eye(3, device=self.device)
        ext = sum(torch.abs(ops.qrot(rot, axes[i][:, None] * self.he[i], V)) for i in range(3))
        ext = torch.where(self.is_box, ext, self.radius)
        lo, hi = pos - ext, pos + ext
        pa, pb = self.pair_a, self.pair_b
        ok = ((lo[..., pa] <= hi[..., pb] + PAIR_MARGIN)
              & (lo[..., pb] <= hi[..., pa] + PAIR_MARGIN)).all(dim=-2)
        order = torch.argsort((~ok).to(torch.uint8), dim=-1, stable=True)[..., :self.budget]
        valid = torch.arange(self.budget, device=self.device) < ok.sum(dim=-1, keepdim=True)
        return pa[order], pb[order], valid

    def pair_contacts(self, pos, rot, a, b, valid):
        """Contacts of the candidate pairs [W, budget], PAIR_POINTS slots each
        ([k, budget] flattened): sphere-sphere and sphere-box at one point;
        box-box by the separating axis of least overlap among the six face
        normals, at the incident box's deepest corners."""
        g3 = lambda x, i: torch.gather(x, -1, i.unsqueeze(-2).expand(x.shape[:-2] + (x.shape[-2],) + i.shape[-1:]))  # noqa: E731,E501
        pa, ra_, pb, rb_ = g3(pos, a), g3(rot, a), g3(pos, b), g3(rot, b)
        ha, hb = self.he[:, a].movedim(0, -2), self.he[:, b].movedim(0, -2)
        rad_a, rad_b = self.radius[a], self.radius[b]
        box_a, box_b = self.is_box[a], self.is_box[b]
        k = PAIR_POINTS

        def one_point(pt, n, d):
            first = (torch.arange(k, device=self.device) == 0)[:, None]
            return (torch.where(first, pt[..., :, None, :], 0.0),
                    torch.where(first, n[..., :, None, :], 0.0),
                    torch.where(first, d[..., None, :], -1.0))

        def unit(v):
            dist = torch.sqrt(torch.clamp_min(ops.dot(v, v, V), 1e-12))
            return v / dist.unsqueeze(-2), dist

        n_ss, dist = unit(pb - pa)
        ss = one_point(pa + n_ss * rad_a.unsqueeze(-2), n_ss, rad_a + rad_b - dist)
        # a sphere against a box: the box's closest point to the sphere's centre
        inside = ops.qrot(ops.qconj(rb_, V), pa - pb, V)
        near = pb + ops.qrot(rb_, torch.minimum(torch.maximum(inside, -hb), hb), V)
        n_sb, dist = unit(near - pa)
        sb = one_point(near, n_sb, rad_a - dist)
        inside = ops.qrot(ops.qconj(ra_, V), pb - pa, V)
        near = pa + ops.qrot(ra_, torch.minimum(torch.maximum(inside, -ha), ha), V)
        n_bs, dist = unit(pb - near)
        bs = one_point(near, n_bs, rad_b - dist)
        # box against box
        eye = torch.eye(3, device=self.device)
        ax_a = [ops.qrot(ra_, eye[i][:, None].expand_as(pa), V) for i in range(3)]
        ax_b = [ops.qrot(rb_, eye[i][:, None].expand_as(pb), V) for i in range(3)]
        d_ab = pb - pa

        def reach(axes, he, u):
            return sum(he[..., i, :] * torch.abs(ops.dot(axes[i], u, V)) for i in range(3))

        best = normal = from_a = None
        for src, axes in ((True, ax_a), (False, ax_b)):
            for u in axes:
                du = ops.dot(d_ab, u, V)
                overlap = reach(ax_a, ha, u) + reach(ax_b, hb, u) - torch.abs(du)
                n_u = u * torch.where(du < 0, -1.0, 1.0).unsqueeze(-2)
                if best is None:
                    best, normal = overlap, n_u
                    from_a = torch.full_like(overlap, src, dtype=torch.bool)
                    continue
                better = overlap < best
                normal = torch.where(better.unsqueeze(-2), n_u, normal)
                from_a = torch.where(better, src, from_a)
                best = torch.minimum(best, overlap)
        ca, cb = self.corners(pa, ra_, ha), self.corners(pb, rb_, hb)
        top_a = ops.dot(pa, normal, V) + reach(ax_a, ha, normal)
        bot_b = ops.dot(pb, normal, V) - reach(ax_b, hb, normal)
        nn = normal[..., :, None, :]
        dep = torch.where(from_a[..., None, :], top_a[..., None, :] - ops.dot(cb, nn, P_AX),
                          ops.dot(ca, nn, P_AX) - bot_b[..., None, :])
        pts = torch.where(from_a[..., None, None, :], cb, ca)
        dep = torch.where(best[..., None, :] > 0.0, torch.minimum(dep, best[..., None, :]), -1.0)
        dsort, idx = torch.sort(dep.transpose(-1, -2), dim=-1, descending=True, stable=True)
        idx = idx[..., :k].transpose(-1, -2)
        bb = (torch.gather(pts, -2, idx.unsqueeze(-3).expand(pts.shape[:-3] + (3,) + idx.shape[-2:])),
              nn.expand(pts.shape[:-2] + (k, pts.shape[-1])), dsort[..., :k].transpose(-1, -2))
        kind_bb, kind_sb, kind_bs = box_a & box_b, ~box_a & box_b, box_a & ~box_b
        parts = []
        for j, vec in enumerate((True, True, False)):
            m = (lambda x: x.unsqueeze(-2).unsqueeze(-2)) if vec else (lambda x: x.unsqueeze(-2))
            parts.append(torch.where(m(kind_bb), bb[j], torch.where(
                m(kind_sb), sb[j], torch.where(m(kind_bs), bs[j], ss[j]))).flatten(-2))
        pt, n, d = parts
        fr = torch.sqrt(torch.clamp_min(self.friction[a] * self.friction[b], 0.0))
        return SimpleNamespace(a=a.repeat(1, k), b=b.repeat(1, k), point=pt, normal=n, depth=d,
                               active=(d > 0.0) & (ops.dot(n, n, V) > 1e-6) & valid.repeat(1, k),
                               friction=fr.repeat(1, k))

    def bodies(self, s, dt) -> None:
        ph = "modules.physics."
        pos, rot, vel, angvel = (s[ph + k] for k in ("pos", "rot", "vel", "angvel"))
        h = torch.clamp_max(dt, MAX_DT)
        m = self.dyn.unsqueeze(-2)
        decay = torch.exp(-DAMPING * h)
        vel = torch.where(m, (vel + self.gravity * h) * decay, vel)
        angvel = torch.where(m, angvel * decay, angvel)
        g = self.ground_contacts(pos, rot)
        a, b, valid = self.candidates(pos, rot)
        pc = self.pair_contacts(pos, rot, a, b, valid)
        key = torch.where(valid, a * self.nb + b, -1).to(torch.int32)
        w = pos.shape[0]
        c = SimpleNamespace(
            a=torch.cat([g.a.expand(w, -1), pc.a], -1), b=torch.cat([g.b.expand(w, -1), pc.b], -1),
            point=torch.cat([g.point, pc.point], -1), normal=torch.cat([g.normal, pc.normal], -1),
            depth=torch.cat([g.depth, pc.depth], -1), active=torch.cat([g.active, pc.active], -1),
            friction=torch.cat([g.friction.expand(w, -1), pc.friction], -1))
        # last frame's impulses carry over where the slot holds the same pair
        same = torch.cat([torch.ones_like(g.active), (key == s[ph + "pair_key"]).repeat(1, PAIR_POINTS)],
                         -1)
        warm = [torch.where(same, s[ph + f], 0.0) for f in ("lam_n", "lam_t1", "lam_t2")]
        vel, angvel, dpos, lams = self.solve(pos, rot, vel, angvel, c, h, warm)
        new_pos = pos + vel * h
        wq = torch.cat([angvel, torch.zeros_like(angvel[..., :1, :])], dim=V)
        new_rot = ops.normalized(rot + ops.qmul(wq, rot, V) * (0.5 * h), V)
        pos = torch.where(m, new_pos, pos) + dpos
        rot = torch.where(m, new_rot, rot)
        calm = (ops.dot(vel, vel, V) < SLEEP_V ** 2) & (ops.dot(angvel, angvel, V) < SLEEP_W ** 2)
        sleep = torch.where(calm & self.dyn, s[ph + "sleep"] + 1, 0).to(torch.int32)
        asleep = (sleep >= SLEEP_FRAMES).unsqueeze(-2)
        s.update({ph + "pos": pos, ph + "rot": rot, ph + "vel": torch.where(asleep, 0.0, vel),
                  ph + "angvel": torch.where(asleep, 0.0, angvel), ph + "sleep": sleep,
                  ph + "pair_key": key, ph + "lam_n": lams[0], ph + "lam_t1": lams[1],
                  ph + "lam_t2": lams[2]})

    def solve(self, pos, rot, vel, angvel, c, h, warm):
        """The contact solve: friction in two tangents bounded by mu times the
        normal impulse, every contact's update from the same velocities in
        each of ITERATIONS sweeps, relaxed by the busier body's contact
        count; then the penetration projected out in POSITION_ITERATIONS
        sweeps. -> (vel, angvel, position correction, impulses)."""
        nb = self.nb
        hasb = c.b >= 0
        bb = c.b.clamp_min(0)
        im = self.inv_mass
        act = c.active.to(torch.float32)
        # the world inverse inertia's diagonal: diag(R I^-1 R^T)
        cols = [ops.qrot(rot, torch.eye(3, device=self.device)[j][:, None].expand_as(pos), V)
                for j in range(3)]
        iiw = sum(cols[j] * cols[j] * self.inv_inertia[j] for j in range(3))

        def at(x, idx, ground=None):
            out = torch.gather(x, -1, idx.unsqueeze(-2).expand(x.shape[:-1] + idx.shape[-1:]))
            return out if ground is None else torch.where(ground.unsqueeze(-2), out, 0.0)

        n = c.normal
        helper = torch.zeros_like(n)
        use_x = torch.abs(n[..., 0, :]) < 0.9
        helper[..., 0, :] = torch.where(use_x, 1.0, 0.0)
        helper[..., 1, :] = torch.where(use_x, 0.0, 1.0)
        t1 = ops.normalized(ops.cross(n, helper, V), V)
        t2 = ops.cross(n, t1, V)
        r_a = c.point - at(pos, c.a)
        r_b = c.point - at(pos, bb, hasb)
        ii_a, ii_b = at(iiw, c.a), at(iiw, bb, hasb)
        im_a, im_b = im[c.a], torch.where(hasb, im[bb], 0.0)

        def eff(d):
            ang = lambda r, ii: ops.dot(ops.cross(ii * ops.cross(r, d, V), r, V), d, V)  # noqa: E731
            return torch.clamp_min(im_a + im_b + ang(r_a, ii_a) + ang(r_b, ii_b), 1e-9)

        k_n, k_t1, k_t2 = eff(n), eff(t1), eff(t2)
        deg = torch.zeros(act.shape[:-1] + (nb,), device=self.device)
        deg = deg.scatter_add(-1, c.a, act).scatter_add(-1, bb, act * hasb)
        busy = torch.clamp_min(torch.maximum(torch.gather(deg, -1, c.a),
                                             torch.where(hasb, torch.gather(deg, -1, bb), 0.0)), 1.0)
        relax = torch.clamp_max(1.6 / busy, RELAX)
        relax_p = torch.clamp_max(1.6 / busy, PROJ_RELAX)
        va = at(vel, c.a) + ops.cross(at(angvel, c.a), r_a, V)
        vb = at(vel, bb, hasb) + ops.cross(at(angvel, bb, hasb), r_b, V)
        # no velocity bias while positions are projected; restitution only
        # beyond 0.5 m/s of approach
        vn0 = ops.dot(vb - va, n, V)
        target = torch.clamp_min(torch.where(vn0 < -0.5, -RESTITUTION * vn0, 0.0), 0.0)
        mu = c.friction
        on_b = hasb.unsqueeze(-2)

        def gather_sum(idx, x):   # contact values [W, 3, C] summed per body [W, 3, NB]
            return torch.zeros(x.shape[:-1] + (nb,), device=x.device).scatter_add(
                -1, idx.unsqueeze(-2).expand_as(x), x)

        def per_body(imp, arm_a=None, arm_b=None):
            """What the impulses do to each body: +imp on b, -imp on a (or the
            torques arm x imp)."""
            ib = imp if arm_b is None else ops.cross(arm_b, imp, V)
            ia = imp if arm_a is None else ops.cross(arm_a, imp, V)
            return gather_sum(bb, torch.where(on_b, ib, 0.0)) - gather_sum(c.a, ia)

        def apply(v, w, imp):
            return v + per_body(imp) * im, w + per_body(imp, r_a, r_b) * iiw

        ln = torch.clamp_min(warm[0], 0.0) * act
        lt1, lt2 = warm[1] * act, warm[2] * act
        imp = n * ln.unsqueeze(-2) + t1 * lt1.unsqueeze(-2) + t2 * lt2.unsqueeze(-2)
        v, w = apply(vel, angvel, torch.where(act.unsqueeze(-2) > 0, imp, 0.0))
        for _ in range(ITERATIONS):
            vr = at(v, bb, hasb) + ops.cross(at(w, bb, hasb), r_b, V) - (
                at(v, c.a) + ops.cross(at(w, c.a), r_a, V))
            vn = ops.dot(vr, n, V)
            dln = (torch.clamp_min(ln + (target - vn) / k_n * relax, 0.0) - ln) * act
            limit = mu * (ln + dln)
            nt1 = torch.clamp(lt1 + (-ops.dot(vr, t1, V) / k_t1) * relax, -limit, limit)
            nt2 = torch.clamp(lt2 + (-ops.dot(vr, t2, V) / k_t2) * relax, -limit, limit)
            dt1, dt2 = (nt1 - lt1) * act, (nt2 - lt2) * act
            v, w = apply(v, w, n * dln.unsqueeze(-2) + t1 * dt1.unsqueeze(-2)
                         + t2 * dt2.unsqueeze(-2))
            ln, lt1, lt2 = ln + dln, lt1 + dt1, lt2 + dt2
        dpos = torch.zeros_like(vel)
        lam = torch.zeros_like(act)
        e0 = torch.where(c.active, torch.clamp_min(c.depth - SLOP, 0.0), 0.0)
        k_lin = torch.clamp_min(im_a + im_b, 1e-9)
        for _ in range(POSITION_ITERATIONS):
            sep = ops.dot(at(dpos, bb, hasb) - at(dpos, c.a), n, V)
            new = torch.clamp_min(lam + (e0 - sep) / k_lin * relax_p, 0.0)
            dpos = dpos + per_body(n * ((new - lam) * act).unsqueeze(-2)) * im
            lam = new
        return v, w, dpos, (ln, lt1, lt2)

    # -- particles ------------------------------------------------------------------

    def particles(self, s, dt) -> None:
        """The storm emitter: every slot's script update (time, gravity on
        the velocity, the position), kills below the ground or past the
        particle's life, then as many dead slots as the emission rate owes
        refilled in slot order from the generator, then the outputs of the
        live particles (position, colour, size)."""
        em = self.emitter
        ch, alive = s[em.prefix + "channels"], s[em.prefix + "alive"]
        w = ch.shape[0]
        px, py, pz, vx, vy, vz, t = ch.unbind(-2)
        t = t + dt
        vy = vy - float(np.float32(STORM["gravity"])) * dt
        px, py, pz = px + vx * dt, py + vy * dt, pz + vz * dt
        alive = alive & ~((py < 0.0) | (t > STORM["life"]))
        acc = s[em.prefix + "emit_acc"] + STORM["emit_per_second"] * dt
        owed = torch.floor(acc)
        s[em.prefix + "emit_acc"] = acc - owed
        dead = ~alive
        rank = torch.cumsum(dead.to(torch.int32), dim=-1)
        fill = dead & (rank <= owed.to(torch.int32).unsqueeze(-1))
        zero_key = torch.zeros((w, 2), dtype=torch.int64, device=self.device)
        frame_key = ops.fold_in(ops.fold_in(ops.fold_in(zero_key, s["frame"]), 0), 0)
        emit_key = ops.fold_in(frame_key, 1)
        draws = [em.lo[i] + (em.hi[i] - em.lo[i]) * ops.uniform(ops.fold_in(emit_key, i + 1),
                                                                    em.cap) for i in range(5)]
        spawn = (draws[0], draws[1], draws[2], draws[3], torch.zeros_like(draws[0]), draws[4],
                 torch.zeros_like(draws[0]))
        rows = [torch.where(fill, new, old) for new, old in zip(spawn, (px, py, pz, vx, vy, vz, t))]
        alive = alive | fill
        s[em.prefix + "channels"] = torch.stack(rows, dim=-2)
        s[em.prefix + "alive"] = alive
        scale = rows[6] * STORM["scale_rate"] + STORM["scale0"]
        color = [torch.full_like(rows[0], c) for c in STORM["color"]]
        outs = torch.stack(rows[0:3] + color + [scale], dim=-2)
        s[em.prefix + "outs"] = torch.where(alive.unsqueeze(-2), outs, 0.0)

    # -- the cull pass --------------------------------------------------------------

    def planes(self, s) -> torch.Tensor:
        """Camera 0's six frustum planes [W, 6, 4] (inward normal, offset),
        from its world transform: near, far, left, right, top, bottom, each
        through three corners and turned toward the frustum's centre."""
        pos = s["world.pos"][..., self.cam_slot]
        rot = s["world.rot"][..., self.cam_slot]
        axis = lambda v: ops.qrot(rot, torch.tensor(v, device=self.device).expand_as(pos), -1)  # noqa: E731
        fwd, up, right = axis([0.0, 0.0, -1.0]), axis([0.0, 1.0, 0.0]), axis([1.0, 0.0, 0.0])
        tan = torch.tan(torch.tensor(self.fov, device=self.device) * 0.5)
        corners = {}
        for tag, dist in (("n", self.near), ("f", self.far)):
            hh = tan * np.float32(dist)
            hw = hh * self.aspect
            centre = pos + fwd * np.float32(dist)
            for v, sv in (("t", 1.0), ("b", -1.0)):
                for u, su in (("l", -1.0), ("r", 1.0)):
                    corners[tag + v + u] = centre + up * (sv * hh) + right * (su * hw)
        mid = sum(corners.values()) / 8.0
        out = []
        for a, b, c in (("ntl", "ntr", "nbr"), ("ftl", "fbr", "ftr"), ("ntl", "nbl", "fbl"),
                        ("ntr", "fbr", "nbr"), ("ntl", "ftl", "ftr"), ("nbl", "nbr", "fbr")):
            pa = corners[a]
            nrm = ops.normalized(ops.cross(corners[b] - pa, corners[c] - pa, -1), -1)
            d = -ops.dot(nrm, pa, -1)
            flip = torch.where(ops.dot(nrm, mid, -1) + d < 0.0, -1.0, 1.0)
            out.append(torch.cat([nrm * flip.unsqueeze(-1), (d * flip).unsqueeze(-1)], -1))
        return torch.stack(out, dim=-2)

    def spheres(self, s):
        """The model instances' bounding spheres: centres [W, 3, K] and radii
        scaled by the largest absolute world scale [W, K]."""
        c = s["world.pos"].index_select(-1, self.mi_index)
        scale = s["world.scale"].index_select(-1, self.mi_index)
        return c, self.mi_radius * torch.abs(scale).amax(dim=-2)

    @staticmethod
    def plane_distances(planes, c):
        """[W, 6, K]: each centre's signed distance to each plane."""
        x, y, z = (c[:, i, None, :] for i in range(3))
        p = planes[..., None]
        return ((x * p[:, :, 0] + y * p[:, :, 1]) + z * p[:, :, 2]) + p[:, :, 3]

    def cull(self, s) -> None:
        planes = self.planes(s)
        c, r = self.spheres(s)
        seen = self.plane_distances(planes, c).amin(dim=1) >= -r
        s[FIELD["visible"]] = seen & self.alive.index_select(-1, self.mi_index) & self.mi_mask
        cam = s["world.pos"][..., self.cam_slot, None]
        d2 = ((c - cam) ** 2).sum(dim=-2)
        lod = (d2[..., None, :] > self.lod_dist * self.lod_dist).sum(dim=-2)
        s[FIELD["lod"]] = torch.clamp_max(lod, LODS - 1).to(torch.int32)
        lc = s["world.pos"].index_select(-1, self.pl_index)
        s[FIELD["lights"]] = (self.plane_distances(planes, lc) >= -self.pl_range).all(dim=1) \
            & self.pl_mask

    def margins(self, s):
        """How far each of the cull pass's decisions on the state `s` sits
        from its threshold, in float64: (spheres [W, K], LOD switches in
        distance [W, K], lights [W, L])."""
        planes = self.planes(s).double()
        c, r = self.spheres(s)
        sphere = self.plane_distances(planes, c.double()).amin(dim=1) + r.double()
        cam = s["world.pos"][..., self.cam_slot, None].double()
        dist = torch.linalg.vector_norm(c.double() - cam, dim=-2)
        lod = (dist[..., None, :] - self.lod_dist.double()).abs().nan_to_num(posinf=1e30)
        lights = (self.plane_distances(planes, s["world.pos"].index_select(-1, self.pl_index)
                                       .double()).amin(dim=1) + self.pl_range.double())
        return sphere, lod.amin(dim=-2), lights


def identity_quats(shape, device) -> torch.Tensor:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    q = torch.zeros((4,) + shape, device=device)
    q[3] = 1.0
    return q
