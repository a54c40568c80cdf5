"""The plain reference of the box drop (BASELINE config 3) on the engine's
banded physics branch: what one frame of a world of unit boxes computes,
written from the branch's semantics, straightforwardly and apart from the
program's code. Plain float32 torch; it imports nothing of the program.

A state is a flat dict of tensors batched over worlds [W, ...], named as the
program names its state's fields (``modules.physics.sap_lam``, ...). The
frame, in the engine's phase order:

1. the renderer keeps each model instance's world transform of the frame
   before;
2. rigid bodies: dt clamped to 1/20 s; gravity and exponential damping on
   the velocities; the ground plane's contacts (each box's four deepest
   corners); the bodies' axis-aligned bounds; four sweep orders, one per
   offset of a grid of columns in x and z whose cell is 2.02 times the
   largest bound's extent (within a column by the bound's lowest y, a
   stable sort, then by the column, a stable sort), with each body's rank
   in each; in each sweep, each body paired with its next K bodies in that
   order (K, the window), where the pair's bounds overlap and no earlier
   sweep's window already holds it; the box-box contacts of each pair (the
   face axis of least overlap, the incident box's four deepest corners);
   the window certificate (bodies whose y-bound reaches past their K-th
   successor in the same column); last frame's impulses of each pair and
   ground point carried over through the previous rank maps; the projected
   Jacobi solve (every contact of a sweep updated from the same velocities,
   the sweeps one after another, ten passes, relaxed by the busier body's
   contact count); the positions integrated; the penetration projected out
   (three passes, each push capped at 5 cm); sleep;
3. the bodies' poses written to their entities;
4. the hierarchy and the cull pass (``model.py``'s, on this scene's layout);
   frame and time advance.

Where the pairs sit: the program keeps a sweep's pairs in rank space (slot
(d-1, i) joins ranks i and i+d) and sums impulses by shifted views; here a
sweep's pairs are an explicit list of body indices in that slot order, and
impulses are summed into the bodies by index. The warm-start carry keeps
the program's layout: ``sap_lam`` [W, S, 3, k, K, NB] by slot, ``sap_glam``
[W, 3, G, NB] by body, ``sap_rank`` [W, S, NB].

Departures from the JAX package's branch, all idle in this scene: every
occupied actor slot is a dynamic unit box on layer 0 (no spheres, capsules,
hulls, statics, kinematics, layers, joints, controllers, vehicles, SDFs or
heightfield, hence no polytope grids); restitution is zero and the velocity
target of every contact is 0 (the Baumgarte term is off where positions are
projected); the column keys are computed in int64 and wrapped to int32 as
the program's int32 arithmetic wraps; a pair slot past the last rank is
simply invalid (the program reads zero-padded partners there and masks
them).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import model, ops

V = -2                    # the component axis of [W, C, N] tensors
GRAVITY = (0.0, -9.81, 0.0)
DAMPING = 0.05            # linear and angular
MAX_DT = 1.0 / 20.0
GROUND_FRICTION = 0.6
FRICTION = 0.6            # every box
HALF = 0.5                # the boxes' half extent
SWEEPS = 4
POINTS = 4                # contact points of a pair (k)
GROUND_POINTS = 4         # deepest corners of a box on the ground (G)
ITERATIONS, POSITION_ITERATIONS = 10, 3
SLOP, RELAX, PROJ_RELAX, MAX_PUSH = 0.005, 0.75, 0.8, 0.05
SLEEP_V, SLEEP_W, SLEEP_FRAMES = 0.03, 0.05, 30
FAR = 1e9                 # an empty slot's bounds, moved out of every window
LAST_KEY = 1 << 24        # added to an empty slot's column key
LAST_Y = 1e18             # added to an empty slot's lowest y
CELL = 2.02               # a column's side over the largest bound's extent
PITCH, JITTER, LIFT = 1.1, 0.05, 2.0
PH = "modules.physics."
CARRY = (PH + "sap_lam", PH + "sap_glam", PH + "sap_rank")
COUNTERS = (PH + "counters.active_contacts", PH + "counters.sap_window_miss")

GROUPS = {
    "body": (PH + "pos", PH + "rot", PH + "vel", PH + "angvel"),
    "carry": (PH + "sap_lam", PH + "sap_glam"),
    "transform": ("local.pos", "local.rot", "local.scale", "world.pos", "world.rot",
                  "world.scale", model.FIELD["prev_pos"], model.FIELD["prev_rot"]),
    "clock": ("time",),
}
EXACT = (PH + "sap_rank",) + COUNTERS + (model.FIELD["visible"], model.FIELD["lod"],
                                         model.FIELD["lights"])


@dataclass
class Scene:
    """The drop as data: entity 0 the camera, entity 1 + i box i (actor
    slot i, model instance i)."""

    boxes: np.ndarray      # f32 [n, 3] start positions
    capacity: int          # entity, actor and model-instance slots
    window: int            # K
    camera: tuple          # (position, fov, near, far)


def build(config: dict, seed: int) -> Scene:
    """The scene of the configuration's ``args`` (num_bodies, capacity,
    window) from the seed: the first n cells of a cubic lattice at 1.1 m
    pitch (x, then y, then z), each jittered by U(0, 5 cm) per axis from
    numpy's generator, lifted 2 m; the camera 35 m in front of the lattice's
    near face, level with its middle, 70 degrees, 0.3 to 300 m."""
    args = config["args"]
    n, cap, window = int(args["num_bodies"]), int(args["capacity"]), int(args["window"])
    rng = np.random.default_rng(int(seed))
    side = int(np.ceil(n ** (1 / 3)))
    cells = np.array([(x, y, z) for x in range(side) for y in range(side)
                      for z in range(side)][:n], np.float64)
    boxes = (cells * PITCH + rng.uniform(0, JITTER, (n, 3)) + [0.0, LIFT, 0.0]).astype(np.float32)
    span = PITCH * (side - 1)
    camera = ((0.5 * span, LIFT + 0.5 * span, span + 35.0), np.float32(np.radians(70.0)),
              np.float32(0.3), np.float32(300.0))
    return Scene(boxes, cap, window, camera)


def _t(a, device, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def _at(x, idx):
    """x [W, NB] or [W, C, NB] at per-world body indices idx [W, P]."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -1, idx.unsqueeze(-2).expand(x.shape[:-1] + idx.shape[-1:]))


def _add(acc, idx, x):
    """acc [W, C, NB] with x [W, C, M] summed into bodies idx [W, M]."""
    return acc.scatter_add(-1, idx.unsqueeze(-2).expand(x.shape), x)


def _wrap32(x):
    """int64 wrapped to the int32 range, as int32 arithmetic wraps."""
    return torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)


class _Scenery(model.Model):
    """The default reference's hierarchy and cull pass on this scene's
    layout: every entity a root (slot = entity), model instance i on box i,
    camera 0 on entity 0, the renderer's 256 point-light slots empty."""

    def __init__(self, scene: Scene, device):
        self.device = dev = torch.device(device)
        n, cap = len(scene.boxes), scene.capacity
        self.levels = []
        alive = np.zeros(cap, bool)
        alive[:n + 1] = True
        self.alive = _t(alive, dev)
        mi = np.zeros(cap, np.int64)
        mi[:n] = np.arange(1, n + 1)
        mask = np.zeros(cap, bool)
        mask[:n] = True
        self.mi_index, self.mi_mask = _t(mi, dev), _t(mask, dev)
        radius, lods = model.MODELS["cube"]
        self.mi_radius = torch.full((cap,), radius, dtype=torch.float32, device=dev)
        self.lod_dist = _t(np.tile(np.array(lods, np.float32)[:, None], (1, cap)), dev)
        _pos, self.fov, self.near, self.far = scene.camera
        self.cam_slot, self.aspect = 0, np.float32(16.0 / 9.0)
        self.pl_index = torch.zeros(256, dtype=torch.int64, device=dev)
        self.pl_mask = torch.zeros(256, dtype=torch.bool, device=dev)
        self.pl_range = torch.full((256,), 10.0, device=dev)


class Model:
    """The scene's constants on `device`, and its frame."""

    def __init__(self, scene: Scene, device):
        self.scene, self.device = scene, torch.device(device)
        dev = self.device
        n, nb, k = len(scene.boxes), scene.capacity, scene.window
        self.n, self.nb, self.K = n, nb, k
        self.view = _Scenery(scene, dev)
        occ = np.zeros(nb, bool)
        occ[:n] = True
        self.occ = _t(occ, dev)
        self.body_slots = torch.arange(1, n + 1, device=dev)
        self.body_cols = torch.arange(n, device=dev)
        mass = np.ones(nb, np.float32)
        he = np.full(nb, HALF, np.float32)
        box = mass / 12.0 * ((2 * he) ** 2 + (2 * he) ** 2)
        self.inv_mass = _t(np.where(occ, 1.0 / mass, 0.0).astype(np.float32), dev)
        self.inv_inertia = _t(np.tile(np.where(occ, 1.0 / np.maximum(box, 1e-9), 0.0)
                                      .astype(np.float32), (3, 1)), dev)
        self.he = torch.full((3, 1), HALF, device=dev)
        self.gravity = _t(np.array(GRAVITY, np.float32)[:, None], dev)
        signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                         np.float32).T
        self.corner_signs = _t(signs, dev)                          # [3, 8]
        fric = torch.full((1,), FRICTION, device=dev)
        self.pair_mu = torch.sqrt(torch.clamp_min(fric * fric, 0.0))
        self.ground_mu = torch.sqrt(torch.clamp_min(fric * GROUND_FRICTION, 0.0))
        # a sweep's pair slots p = (d - 1) * NB + i join ranks i and i + d
        p = torch.arange(k * nb, device=dev)
        self.slot_rank = p % nb
        self.partner_rank = self.slot_rank + p // nb + 1
        self.slot_valid = self.partner_rank < nb
        self.partner_rank = torch.clamp_max(self.partner_rank, nb - 1)
        self.eye = torch.eye(3, device=dev)

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
        sc, dev, nb, k = self.scene, self.device, self.nb, self.K
        cap, n = sc.capacity, self.n
        pos = np.zeros((3, cap), np.float32)
        pos[:, 0] = sc.camera[0]
        pos[:, 1:n + 1] = sc.boxes.T
        rot = np.zeros((4, cap), np.float32)
        rot[3] = 1.0
        one = {"local.pos": _t(pos, dev), "local.rot": _t(rot, dev),
               "local.scale": torch.ones((3, cap), device=dev)}
        for f in ("pos", "rot", "scale"):
            one[f"world.{f}"] = one[f"local.{f}"].clone()
        one["frame"] = torch.zeros((), dtype=torch.int32, device=dev)
        one["time"] = torch.zeros((), device=dev)
        one[model.FIELD["prev_pos"]] = torch.zeros((3, cap), device=dev)
        one[model.FIELD["prev_rot"]] = model.identity_quats(cap, dev)
        one[model.FIELD["visible"]] = torch.zeros(cap, dtype=torch.bool, device=dev)
        one[model.FIELD["lod"]] = torch.zeros(cap, dtype=torch.int32, device=dev)
        one[model.FIELD["lights"]] = torch.zeros(256, dtype=torch.bool, device=dev)
        bpos = np.zeros((3, nb), np.float32)
        bpos[:, :n] = sc.boxes.T
        one.update({PH + "pos": _t(bpos, dev), PH + "rot": model.identity_quats(nb, dev),
                    PH + "vel": torch.zeros((3, nb), device=dev),
                    PH + "angvel": torch.zeros((3, nb), device=dev),
                    PH + "sleep": torch.zeros(nb, dtype=torch.int32, device=dev),
                    CARRY[0]: torch.zeros((SWEEPS, 3, POINTS, k, nb), device=dev),
                    CARRY[1]: torch.zeros((3, GROUND_POINTS, nb), device=dev),
                    CARRY[2]: torch.full((SWEEPS, nb), -1, dtype=torch.int32, device=dev)})
        one.update({c: torch.zeros((), dtype=torch.int32, device=dev) for c in COUNTERS})
        rows = torch.arange(worlds, device=dev) if rows is None else rows.to(dev)
        state = {key: v.unsqueeze(0).expand((len(rows),) + v.shape).clone()
                 for key, v in one.items()}

        def noise(shape):
            draw = torch.randn((worlds,) + shape[1:], generator=generator, device=generator.device)
            return draw.to(dev).index_select(0, rows)

        state["local.pos"] = state["local.pos"] + noise(state["local.pos"].shape) * 0.01
        stag = torch.randint(0, 16, (worlds, nb), generator=generator,
                             device=generator.device).to(dev, torch.int32).index_select(0, rows)
        state[PH + "sleep"] = torch.maximum(state[PH + "sleep"], stag)
        state[PH + "vel"] = state[PH + "vel"] + noise(state[PH + "vel"].shape) * 0.05
        state[PH + "angvel"] = state[PH + "angvel"] + noise(state[PH + "angvel"].shape) * 0.05
        return state

    # -- the frame ------------------------------------------------------------------

    def frame(self, s: dict, dt: float) -> dict:
        """The state after one frame of dt seconds (a new dict; `s` is read)."""
        dt = torch.tensor(dt, dtype=torch.float32, device=self.device)
        s = {key: s[key] for key in self.names}
        vw = self.view
        s[model.FIELD["prev_pos"]] = s["world.pos"].index_select(-1, vw.mi_index)
        s[model.FIELD["prev_rot"]] = s["world.rot"].index_select(-1, vw.mi_index)
        self.bodies(s, dt)
        for f in ("pos", "rot"):
            s[f"local.{f}"] = s[f"local.{f}"].index_copy(
                -1, self.body_slots, s[PH + f].index_select(-1, self.body_cols))
        s.update({f"world.{f}": v for f, v in vw.propagate(
            {f: s[f"local.{f}"] for f in ("pos", "rot", "scale")}).items()})
        vw.cull(s)
        s["frame"] = s["frame"] + 1
        s["time"] = s["time"] + dt
        return s

    # -- the broadphase -------------------------------------------------------------

    def bounds(self, pos, rot):
        """Each body's axis-aligned bounds (lo, hi [W, 3, NB]); an empty
        slot's moved FAR along every axis."""
        z = torch.zeros_like(pos[..., 0, :])
        h = torch.full_like(z, HALF)
        ext = sum(torch.abs(ops.qrot(rot, torch.stack(v, dim=V), V))
                  for v in ((h, z, z), (z, h, z), (z, z, h)))
        far = torch.where(self.occ, 0.0, FAR)
        return pos - ext + far, pos + ext + far

    def sweeps(self, lo, hi):
        """The four column sweeps: (orders [W, NB] rank -> body, ranks [W,
        NB] body -> rank, column keys [W, NB] by body, each body's distance
        in metres to its column's walls [W, NB]), one tuple per sweep."""
        mid = 0.5 * (lo + hi)
        ext = torch.where(self.occ.unsqueeze(-2), hi - lo, 0.0)
        cell = torch.clamp_min(CELL * ext.amax(dim=(-2, -1)), 1e-3).unsqueeze(-1)
        half = 0.5 * cell
        last_key = torch.where(self.occ, 0, LAST_KEY)
        last_y = torch.where(self.occ, 0.0, LAST_Y)
        iota = torch.arange(self.nb, device=self.device).expand(lo.shape[0], -1)
        out = []
        for ox, oz in ((0.0, 0.0), (half, 0.0), (0.0, half), (half, half)):
            qx = torch.floor((mid[..., 0, :] - ox) / cell)
            qz = torch.floor((mid[..., 2, :] - oz) / cell)
            wall = torch.minimum(self._wall(mid[..., 0, :], ox, cell),
                                 self._wall(mid[..., 2, :], oz, cell))
            key = _wrap32(qx.to(torch.int64) * 65536 + torch.remainder(qz.to(torch.int64), 65536))
            by_y = torch.argsort(lo[..., 1, :] + last_y, dim=-1, stable=True)
            sort_key = _wrap32(torch.gather(key + last_key, -1, by_y))
            order = torch.gather(by_y, -1, torch.argsort(sort_key, dim=-1, stable=True))
            rank = torch.empty_like(order).scatter_(-1, order, iota)
            out.append((order, rank, key, wall))
        return out

    @staticmethod
    def _wall(x, off, cell):
        """Metres from x to the nearer wall of its column (float64)."""
        t = (x.double() - (off.double() if torch.is_tensor(off) else off)) / cell.double()
        f = t - torch.floor(t)
        return torch.minimum(f, 1.0 - f) * cell.double()

    def pairs(self, order):
        """A sweep's pair slots: (a, b [W, K * NB] body indices, rank valid [K * NB])."""
        w = order.shape[0]
        a = torch.gather(order, -1, self.slot_rank.expand(w, -1))
        b = torch.gather(order, -1, self.partner_rank.expand(w, -1))
        return a, b, self.slot_valid

    # -- the narrowphase ------------------------------------------------------------

    def corners(self, pos, rot):
        """Box corners [W, 3, 8, n] of unit boxes at pos, rot [W, 3|4, n]."""
        local = self.he[:, None, :] * self.corner_signs[:, :, None]
        return pos[..., :, None, :] + ops.qrot(rot[..., :, None, :], local, -3)

    def ground(self, pos, rot):
        """Each box's four deepest corners under the plane y = 0: (point [W,
        3, G, NB], depth [W, G, NB]); the normal is -y (box to ground)."""
        c = self.corners(pos, rot)
        depth, idx = torch.sort((0.0 - c[..., 1, :, :]).transpose(-1, -2), dim=-1,
                                descending=True, stable=True)
        idx = idx[..., :GROUND_POINTS].transpose(-1, -2)
        point = torch.gather(c, -2, idx.unsqueeze(-3).expand(c.shape[:-3] + (3,) + idx.shape[-2:]))
        return point, depth[..., :GROUND_POINTS].transpose(-1, -2)

    def box_box(self, pa, ra, pb, rb):
        """Contacts of box pairs at pa, ra and pb, rb [W, 3|4, P]: the face
        axis of either box with the least overlap (the first found on ties,
        a's before b's), the normal along it from a to b, and the incident
        box's four corners deepest past the reference face, each no deeper
        than the overlap. -> (point [W, 3, k, P], normal [W, 3, k, P],
        depth [W, k, P]); no overlap gives depth -1."""
        ax_a = [ops.qrot(ra, self.eye[i][:, None].expand_as(pa), V) for i in range(3)]
        ax_b = [ops.qrot(rb, self.eye[i][:, None].expand_as(pb), V) for i in range(3)]
        d_ab = pb - pa

        def reach(axes, u):
            return sum(HALF * torch.abs(ops.dot(axes[i], u, V)) for i in range(3))

        best = normal = from_a = None
        for src, axes in ((True, ax_a), (False, ax_b)):
            for u in axes:
                du = ops.dot(d_ab, u, V)
                overlap = reach(ax_a, u) + reach(ax_b, u) - torch.abs(du)
                n_u = u * torch.where(du < 0, -1.0, 1.0).unsqueeze(V)
                if best is None:
                    best, normal = overlap, n_u
                    from_a = torch.full_like(overlap, src, dtype=torch.bool)
                    continue
                better = overlap < best
                normal = torch.where(better.unsqueeze(V), n_u, normal)
                from_a = torch.where(better, src, from_a)
                best = torch.minimum(best, overlap)
        ca, cb = self.corners(pa, ra), self.corners(pb, rb)
        top_a = ops.dot(pa, normal, V) + reach(ax_a, normal)
        bot_b = ops.dot(pb, normal, V) - reach(ax_b, normal)
        nn = normal[..., :, None, :]
        dep = torch.where(from_a[..., None, :], top_a[..., None, :] - ops.dot(cb, nn, -3),
                          ops.dot(ca, nn, -3) - bot_b[..., None, :])
        pts = torch.where(from_a[..., None, None, :], cb, ca)
        dep = torch.where(best[..., None, :] > 0.0, torch.minimum(dep, best[..., None, :]), -1.0)
        dsort, idx = torch.sort(dep.transpose(-1, -2), dim=-1, descending=True, stable=True)
        idx = idx[..., :POINTS].transpose(-1, -2)
        point = torch.gather(pts, -2,
                             idx.unsqueeze(-3).expand(pts.shape[:-3] + (3,) + idx.shape[-2:]))
        return point, nn.expand(point.shape), dsort[..., :POINTS].transpose(-1, -2)

    # -- the rigid bodies -----------------------------------------------------------

    def bodies(self, s, dt) -> None:
        pos, rot, vel, angvel = (s[PH + f] for f in ("pos", "rot", "vel", "angvel"))
        h = torch.clamp_max(dt, MAX_DT)
        m = self.occ.unsqueeze(-2)
        decay = torch.exp(-DAMPING * h)
        vel = torch.where(m, (vel + self.gravity * h) * decay, vel)
        angvel = torch.where(m, angvel * decay, angvel)
        w, nb, K = pos.shape[0], self.nb, self.K

        g_point, g_depth = self.ground(pos, rot)
        g_active = (g_depth > 0.0) & self.occ
        lo, hi = self.bounds(pos, rot)
        sweeps = self.sweeps(lo, hi)
        sets, margin = self.pair_sets(pos, rot, lo, hi, sweeps)
        ground_near = torch.where(self.occ, g_depth.double().abs(), float("inf"))
        margin = torch.minimum(margin, ground_near.amin(dim=(-2, -1)))
        n_active = (g_active.sum(dim=(-2, -1))
                    + sum(c["active"].sum(dim=(-2, -1)) for c in sets)).to(torch.int32)
        certs = [self.certificate(order, key, wall, lo, hi) for order, _r, key, wall in sweeps]

        self.warm(sets, s)
        iiw = self.inv_inertia_world(rot)
        body = torch.arange(nb, device=self.device).expand(w, -1)
        deg = _add(torch.zeros((w, 1, nb), device=self.device), body.repeat(1, GROUND_POINTS),
                   g_active.flatten(-2).unsqueeze(-2).float())
        for c in sets:
            act = c["active"].flatten(-2).unsqueeze(-2).float()
            deg = _add(_add(deg, c["a"].repeat(1, POINTS), act), c["b"].repeat(1, POINTS), act)
        deg = deg.squeeze(-2)
        ground = self.ground_contacts(g_point, g_depth, g_active, pos, iiw, deg)
        ground["warm"] = [s[CARRY[1]][:, j].flatten(-2) for j in range(3)]  # by body
        for c in sets:
            self.pair_constants(c, pos, iiw, deg)
        vel, angvel = self.solve(vel, angvel, iiw, ground, sets)
        new_pos = pos + vel * h
        wq = torch.cat([angvel, torch.zeros_like(angvel[..., :1, :])], dim=V)
        new_rot = ops.normalized(rot + ops.qmul(wq, rot, V) * (0.5 * h), V)
        pos = self.project(torch.where(m, new_pos, pos), ground, sets)
        rot = torch.where(m, new_rot, rot)
        calm = (ops.dot(vel, vel, V) < SLEEP_V ** 2) & (ops.dot(angvel, angvel, V) < SLEEP_W ** 2)
        sleep = torch.where(calm & self.occ, s[PH + "sleep"] + 1, 0).to(torch.int32)
        asleep = (sleep >= SLEEP_FRAMES).unsqueeze(-2)
        s.update({PH + "pos": pos, PH + "rot": rot, PH + "vel": torch.where(asleep, 0.0, vel),
                  PH + "angvel": torch.where(asleep, 0.0, angvel), PH + "sleep": sleep,
                  CARRY[0]: torch.stack([torch.stack(c["lam"], dim=1).reshape(
                      (w, 3, POINTS, K, nb)) for c in sets], dim=1),
                  CARRY[1]: torch.stack(ground["lam"], dim=1).reshape((w, 3, GROUND_POINTS, nb)),
                  CARRY[2]: torch.stack([r for _o, r, _k, _w in sweeps], dim=1).to(torch.int32),
                  COUNTERS[0]: n_active, COUNTERS[1]: sum(n for n, _g in certs)})
        miss_margin = torch.stack([g for _n, g in certs]).amin(dim=0)
        self._margins = (self.rank_margins(sweeps, lo), margin, miss_margin)

    def pair_sets(self, pos, rot, lo, hi, sweeps):
        """Each sweep's pair contacts: the next K bodies of each in its
        order, where both slots hold a box, the bounds overlap and no earlier
        sweep's window holds the pair -> (one dict a sweep: a, b [W, P],
        point, normal [W, 3, k, P], depth, active [W, k, P]; how far the
        contact decisions sit from their thresholds [W]: each held pair's
        bound test (overlapping: its least slack; apart: its most violated
        axis) and each overlapping pair's depths)."""
        w, K = pos.shape[0], self.K
        occ = self.occ.expand(w, -1)
        sets = []
        margin = torch.full((w,), float("inf"), dtype=torch.float64, device=self.device)
        for s_i, (order, _rank, _key, _wall) in enumerate(sweeps):
            a, b, valid = self.pairs(order)
            lo_a, hi_a, lo_b, hi_b = _at(lo, a), _at(hi, a), _at(lo, b), _at(hi, b)
            overlap = ((lo_a <= hi_b) & (lo_b <= hi_a)).all(dim=V)
            held = valid & _at(occ, a) & _at(occ, b)
            for _order, r_prev, _key, _wall in sweeps[:s_i]:
                held = held & ((_at(r_prev, b) - _at(r_prev, a)).abs() > K)
            point, normal, depth = self.box_box(_at(pos, a), _at(rot, a), _at(pos, b), _at(rot, b))
            active = ((depth > 0.0) & (ops.dot(normal, normal, -3) > 1e-6)
                      & (overlap & held).unsqueeze(-2))
            sets.append(dict(a=a, b=b, point=point, normal=normal, depth=depth, active=active))
            gap = torch.minimum(hi_b - lo_a, hi_a - lo_b).double().amin(dim=V).abs()
            near = torch.where((held & overlap).unsqueeze(-2), depth.double().abs(), float("inf"))
            margin = torch.minimum(margin, torch.minimum(
                torch.where(held, gap, float("inf")).amin(dim=-1), near.amin(dim=(-2, -1))))
        return sets, margin

    def certificate(self, order, key, wall, lo, hi):
        """The window certificate of one sweep: the occupied bodies whose
        bound reaches in y past their K-th successor in the same column ->
        (count [W] int32, how far its decisions sit from their thresholds
        [W]: the y gap of each same-column pair, and the column walls of
        each pair whose bounds reach)."""
        w, nb, K = order.shape[0], self.nb, self.K
        i = torch.arange(nb - K - 1, device=self.device).expand(w, -1)
        a, b = torch.gather(order, -1, i), torch.gather(order, -1, i + K + 1)
        reach = _at(hi[..., 1, :], a) >= _at(lo[..., 1, :], b)
        same = _at(key, a) == _at(key, b)
        occ = _at(self.occ.expand(w, -1), a)
        count = (reach & same & occ).sum(dim=-1).to(torch.int32)
        dy = (_at(hi[..., 1, :], a).double() - _at(lo[..., 1, :], b).double()).abs()
        walls = torch.minimum(_at(wall, a), _at(wall, b))
        gap = torch.minimum(torch.where(same & occ, dy, float("inf")),
                            torch.where(reach & occ, walls, float("inf")))
        return count, gap.amin(dim=-1)

    def rank_margins(self, sweeps, lo):
        """[W, S, NB] by body: the column walls' distance, and the gap in
        lowest y to the neighbours in the order within the same column (the
        adjacent sort keys)."""
        out = []
        for order, _rank, key, wall in sweeps:
            y = torch.gather(lo[..., 1, :], -1, order).double()
            k = torch.gather(key, -1, order)
            gap = torch.full_like(y, float("inf"))
            step = torch.where(k[..., 1:] == k[..., :-1], (y[..., 1:] - y[..., :-1]).abs(),
                               float("inf"))
            gap[..., 1:] = torch.minimum(gap[..., 1:], step)
            gap[..., :-1] = torch.minimum(gap[..., :-1], step)
            by_body = torch.empty_like(gap).scatter_(-1, order, gap)
            out.append(torch.minimum(by_body, wall))
        return torch.stack(out, dim=1)

    def warm(self, sets, s) -> None:
        """Last frame's impulses: a pair slot takes those of the same two
        bodies where they sat in the previous frame's window of this sweep
        (in either order: swapped, the second tangent's flips). Cold ranks
        (-1) carry nothing."""
        prev_lam, prev_rank = s[CARRY[0]], s[CARRY[2]]
        K, nb = self.K, self.nb
        for s_i, c in enumerate(sets):
            lam = prev_lam[:, s_i].reshape(prev_lam.shape[:1] + (3, POINTS, K * nb))
            ra = _at(prev_rank[:, s_i].long(), c["a"])
            rb = _at(prev_rank[:, s_i].long(), c["b"])
            delta = rb - ra
            fwd = (delta >= 1) & (delta <= K)
            bwd = (delta <= -1) & (delta >= -K)
            ok = (fwd | bwd) & (ra >= 0) & (rb >= 0) & self.slot_valid
            src = torch.where(fwd, (delta - 1) * nb + ra, (-delta - 1) * nb + rb)
            src = torch.where(ok, src, 0)
            got = torch.gather(lam, -1, src[:, None, None, :].expand(lam.shape))
            got = torch.where(ok[:, None, None, :], got, 0.0)
            sign = torch.where(bwd, -1.0, 1.0)[:, None, :]
            c["warm"] = [got[:, 0], got[:, 1], got[:, 2] * sign]

    def inv_inertia_world(self, rot):
        """The world inverse inertia's diagonal, diag(R I^-1 R^T) [W, 3, NB]."""
        x, y, z, w = rot.unbind(V)
        xx, yy, zz, xy, xz, yz = x * x, y * y, z * z, x * y, x * z, y * z
        wx, wy, wz = w * x, w * y, w * z
        rows = [(1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
                (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
                (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))]
        ib = self.inv_inertia
        return torch.stack([sum(r[j] * ib[j] * r[j] for j in range(3)) for r in rows], dim=V)

    # -- the solve ------------------------------------------------------------------

    @staticmethod
    def tangents(n):
        """Two unit tangents of normals n [W, 3, ...]."""
        use_x = torch.abs(n[:, 0]) < 0.9
        helper = torch.stack([torch.where(use_x, 1.0, 0.0), torch.where(use_x, 0.0, 1.0),
                              torch.zeros_like(n[:, 0])], dim=1)
        t1 = ops.normalized(ops.cross(n, helper, 1), 1)
        return t1, ops.cross(n, t1, 1)

    @staticmethod
    def turn(r, d, ii):
        """The rotational part of a body's inverse effective mass along d at
        arm r: d . ((I^-1 (r x d)) x r)."""
        return ops.dot(ops.cross(ii * ops.cross(r, d, 1), r, 1), d, 1)

    def ground_contacts(self, point, depth, active, pos, iiw, deg):
        """The ground points' constants: arms, tangents, effective masses,
        relaxation, friction, and their warm impulses (in `sets[0]`)."""
        w, nb = pos.shape[0], self.nb
        body = torch.arange(nb, device=self.device).expand(w, -1).repeat(1, GROUND_POINTS)
        g = dict(a=body, point=point.flatten(-2), depth=depth.flatten(-2),
                 active=active.flatten(-2))
        g["normal"] = torch.zeros_like(g["point"])
        g["normal"][:, 1] = -1.0
        g["r"] = g["point"] - _at(pos, body)
        g["t1"], g["t2"] = self.tangents(g["normal"])
        im, ii = _at(self.inv_mass.expand(w, -1), body), _at(iiw, body)
        for name, d in (("kn", g["normal"]), ("kt1", g["t1"]), ("kt2", g["t2"])):
            g[name] = torch.clamp_min(im + self.turn(g["r"], d, ii), 1e-9)
        dg = _at(deg, body)
        g["relax"] = torch.clamp_max(1.6 / torch.clamp_min(dg, 1.0), RELAX)
        g["relax_p"] = torch.clamp_max(1.6 / torch.clamp_min(dg, 1.0), PROJ_RELAX)
        g["k_lin"] = torch.clamp_min(im, 1e-9)
        g["mu"] = self.ground_mu
        return g

    def pair_constants(self, c, pos, iiw, deg) -> None:
        """A sweep's pair contacts flattened to [W, (3,) k * P] with their
        arms, tangents, effective masses, relaxation and friction."""
        w = pos.shape[0]
        a, b = c["a"].repeat(1, POINTS), c["b"].repeat(1, POINTS)
        c.update(a=a, b=b, point=c["point"].flatten(-2), normal=c["normal"].flatten(-2),
                 depth=c["depth"].flatten(-2), active=c["active"].flatten(-2),
                 warm=[x.flatten(-2) for x in c["warm"]])
        c["ra"], c["rb"] = c["point"] - _at(pos, a), c["point"] - _at(pos, b)
        c["t1"], c["t2"] = self.tangents(c["normal"])
        im = self.inv_mass.expand(w, -1)
        im_a, im_b, ii_a, ii_b = _at(im, a), _at(im, b), _at(iiw, a), _at(iiw, b)
        for name, d in (("kn", c["normal"]), ("kt1", c["t1"]), ("kt2", c["t2"])):
            c[name] = torch.clamp_min(im_a + im_b + self.turn(c["ra"], d, ii_a)
                                      + self.turn(c["rb"], d, ii_b), 1e-9)
        busy = torch.clamp_min(torch.maximum(_at(deg, a), _at(deg, b)), 1.0)
        c["relax"] = torch.clamp_max(1.6 / busy, RELAX)
        c["relax_p"] = torch.clamp_max(1.6 / busy, PROJ_RELAX)
        c["k_lin"] = torch.clamp_min(im_a + im_b, 1e-9)
        c["mu"] = self.pair_mu

    def push(self, c, imp, pair: bool):
        """What the impulses imp [W, 3, M] of contacts c do to each body
        ([W, 3, NB] each): +imp on b and -imp on a, and their torques."""
        zero = imp.new_zeros(imp.shape[:-1] + (self.nb,))
        lin = _add(zero, c["a"], -imp)
        ang = _add(zero, c["a"], -ops.cross(c["ra" if pair else "r"], imp, 1))
        if pair:
            lin = _add(lin, c["b"], imp)
            ang = _add(ang, c["b"], ops.cross(c["rb"], imp, 1))
        return lin, ang

    def solve(self, vel, angvel, iiw, ground, sets):
        """The projected Jacobi solve: the carried impulses applied first,
        then ITERATIONS passes; in each pass, each sweep in turn (the ground
        with the first) updates every one of its contacts from the same
        velocities. -> (vel, angvel)."""
        im = self.inv_mass
        groups = [(ground, False)] + [(c, True) for c in sets]
        for c, pair in groups:
            c["lam"] = [torch.where(c["active"], x, 0.0) for x in c["warm"]]
            imp = self.impulse(c, *c["lam"])
            lin, ang = self.push(c, imp, pair)
            vel, angvel = vel + lin * im, angvel + ang * iiw
        batches = [[(ground, False), (sets[0], True)]] + [[(c, True)] for c in sets[1:]]
        for _ in range(ITERATIONS):
            for batch in batches:
                lin = torch.zeros_like(vel)
                ang = torch.zeros_like(angvel)
                steps = []
                for c, pair in batch:
                    va = _at(vel, c["a"]) + ops.cross(_at(angvel, c["a"]),
                                                      c["ra" if pair else "r"], 1)
                    vb = _at(vel, c["b"]) + ops.cross(_at(angvel, c["b"]), c["rb"], 1) \
                        if pair else 0.0
                    steps.append(self.pgs(c, vb - va))
                for (c, pair), (imp, d) in zip(batch, steps):
                    dl, da = self.push(c, imp, pair)
                    lin, ang = lin + dl, ang + da
                    c["lam"] = [x + y for x, y in zip(c["lam"], d)]
                vel, angvel = vel + lin * im, angvel + ang * iiw
        return vel, angvel

    @staticmethod
    def impulse(c, ln, l1, l2):
        imp = c["normal"] * ln.unsqueeze(1) + c["t1"] * l1.unsqueeze(1) + c["t2"] * l2.unsqueeze(1)
        return torch.where(c["active"].unsqueeze(1), imp, 0.0)

    @staticmethod
    def pgs(c, vr):
        """One Jacobi update of contacts c at relative velocities vr: the
        normal impulse kept non-negative, each friction impulse within mu
        times it. -> (impulse, (dλn, dλt1, dλt2))."""
        ln, l1, l2 = c["lam"]
        act = c["active"]
        vn = ops.dot(vr, c["normal"], 1)
        dln = (0.0 - vn) / c["kn"] * c["relax"]
        dln = torch.where(act, torch.clamp_min(ln + dln, 0.0) - ln, 0.0)
        limit = c["mu"] * (ln + dln)
        n1 = torch.clamp(l1 + (-ops.dot(vr, c["t1"], 1) / c["kt1"]) * c["relax"], -limit, limit)
        n2 = torch.clamp(l2 + (-ops.dot(vr, c["t2"], 1) / c["kt2"]) * c["relax"], -limit, limit)
        d1, d2 = torch.where(act, n1 - l1, 0.0), torch.where(act, n2 - l2, 0.0)
        imp = torch.where(act.unsqueeze(1), c["normal"] * dln.unsqueeze(1)
                          + c["t1"] * d1.unsqueeze(1) + c["t2"] * d2.unsqueeze(1), 0.0)
        return imp, (dln, d1, d2)

    def project(self, pos, ground, sets):
        """The penetration projected out: POSITION_ITERATIONS passes of
        split impulses on positions (each contact's target its depth less
        the slop, capped at MAX_PUSH), each sweep in turn as in the solve."""
        im = self.inv_mass
        dpos = torch.zeros_like(pos)
        batches = [[(ground, False), (sets[0], True)]] + [[(c, True)] for c in sets[1:]]
        for c in [ground] + sets:
            c["e0"] = torch.where(c["active"], torch.clamp(c["depth"] - SLOP, 0.0, MAX_PUSH), 0.0)
            c["push"] = torch.zeros_like(c["depth"])
        for _ in range(POSITION_ITERATIONS):
            for batch in batches:
                acc = torch.zeros_like(dpos)
                for c, pair in batch:
                    sep = _at(dpos, c["b"]) - _at(dpos, c["a"]) if pair else -_at(dpos, c["a"])
                    dl = (c["e0"] - ops.dot(sep, c["normal"], 1)) / c["k_lin"] * c["relax_p"]
                    dl = torch.where(c["active"], torch.clamp_min(c["push"] + dl, 0.0) - c["push"],
                                     0.0)
                    step = torch.where(c["active"].unsqueeze(1), c["normal"] * dl.unsqueeze(1), 0.0)
                    acc = _add(acc, c["a"], -step)
                    if pair:
                        acc = _add(acc, c["b"], step)
                    c["push"] = c["push"] + dl
                dpos = dpos + acc * im
        return pos + dpos

    # -- the decisions --------------------------------------------------------------

    def margins(self, s):
        """How far each decision of the frame that made `s` sits from its
        threshold, in metres (float64), for each field of EXACT in order:
        the ranks [W, S, NB], the contact count and the certificate [W],
        then the cull pass's (spheres, LOD switches, lights)."""
        return self._margins + tuple(self.view.margins(s))
