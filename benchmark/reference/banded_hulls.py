"""The plain reference of the convex-hull debris level on the engine's banded
physics branch: what one frame of a world of cooked hulls over a static
mesh collider computes, written from the branch's semantics,
straightforwardly and apart from the program's code. Plain float32 torch;
it imports nothing of the program. The broadphase, the warm-start match,
the Jacobi solve, the projection, the sleep rule, the hierarchy and the cull
pass are the box drop's (``banded_boxes.py``), which this module builds on;
what differs is written here:

1. the scene: random 10-point hulls in stacks of five at 2 m pitch over an
   8 x 1 x 8 m slab and the ground plane, each hull cooked here (its
   vertices, face axes, bounding radius, volume and inertia) from its
   points;
2. the bounds: a hull's bounding sphere (its farthest vertex from its
   origin) in every direction;
3. the per-body ground stream, G = 4 + V + V slots a body: four slots of
   the plane's primitive stream that no hull takes (never active), then
   each hull vertex against the plane y = 0, then each hull vertex against
   the slab's signed distance field (trilinear in the grid the
   configuration states, normal the field's normalised central difference
   at half a cell);
4. the pair narrowphase: the separating axes of both hulls' face normals
   and the line between their origins, the least overlap's axis (the first
   found on ties: a's faces, b's, the centre line), the manifold the four
   deepest of b's vertices behind a's support plane and a's beyond b's,
   each no deeper than the overlap.

Decisions held exactly (EXACT), each away from 1e-4 of its threshold: the
ranks, the active contact count (the pairs' bound slacks and depths, the
ground and field depths, and the gap between each overlapping pair's two
least overlaps over distinct axes, so that a near-tie between two axes is
left out), the window certificate and the cull's three.

Departures from the program, all idle in this scene: every occupied actor
slot is a dynamic hull of mass 1 and friction 0.6 on layer 0, with no
support radius; the slab sits at the origin unrotated, so its field is
sampled at the world points; the four primitive ground slots are never
active (they hold spheres' and boxes' contacts, and every body is a hull);
the rest as ``banded_boxes.py`` lists.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from benchmark.reference import banded_boxes as bb
from benchmark.reference import model, ops

V_CAP, F_CAP = 16, 12       # a cooked hull's vertex and face-axis slots
POINTS = bb.POINTS          # contact points of a pair (k)
PLANE_SLOTS = 4             # the primitive ground stream's slots a body
STACK, PITCH = 5, 2.0       # hulls a stack, stacks' spacing in metres
MASS, FRICTION = 1.0, 0.6
MODEL_RADIUS = 0.78         # the "hull" model's bounding radius
PH = bb.PH
CARRY, COUNTERS = bb.CARRY, bb.COUNTERS
GROUPS, EXACT = bb.GROUPS, bb.EXACT


@dataclass
class Hull:
    """A cooked hull: local vertices and unit face axes, each padded by
    repeating its first, with the counts of the real ones."""

    verts: np.ndarray        # f32 [V_CAP, 3]
    axes: np.ndarray         # f32 [F_CAP, 3]
    n_verts: int
    n_faces: int
    radius: float            # the farthest vertex's distance from the origin
    volume: float
    inertia: np.ndarray      # f32 [3]: the inertia tensor's diagonal about the centre of mass, unit density


def _spiral(n: int) -> np.ndarray:
    """n directions spread over the sphere on a golden-angle spiral [n, 3]."""
    t = np.arange(n, dtype=np.float64) + 0.5
    polar = np.arccos(1.0 - 2.0 * t / n)
    turn = np.pi * (1.0 + np.sqrt(5.0)) * t
    return np.stack([np.sin(polar) * np.cos(turn), np.sin(polar) * np.sin(turn),
                     np.cos(polar)], axis=1)


def _mass_properties(points, triangles, outward):
    """Volume and the inertia diagonal about the centre of mass at unit
    density of a closed convex surface: each triangle turned to face along
    its outward normal, the solid cut into tetrahedra on the origin."""
    a, b, c = (points[triangles[:, i]] for i in range(3))
    wrong = np.sum(np.cross(b - a, c - a) * outward, axis=1) < 0.0
    b, c = np.where(wrong[:, None], c, b), np.where(wrong[:, None], b, c)
    vol = np.sum(a * np.cross(b, c), axis=1) / 6.0
    volume = float(vol.sum())
    if abs(volume) < 1e-12:
        return 0.0, np.ones(3, np.float32)
    centre = (vol[:, None] * (a + b + c)).sum(axis=0) / (4.0 * volume)
    # the integral of x_i^2 over a tetrahedron on the origin: its volume over 10
    # times the sum of the products of the i-th coordinates of its corners, pairs and squares
    second = np.array([float(np.sum(vol * (a[:, i] ** 2 + b[:, i] ** 2 + c[:, i] ** 2 + a[:, i] * b[:, i]
                                           + a[:, i] * c[:, i] + b[:, i] * c[:, i]) / 10.0))
                       for i in range(3)])
    about_origin = np.array([second[1] + second[2], second[0] + second[2], second[0] + second[1]])
    shift = volume * np.array([centre[1] ** 2 + centre[2] ** 2, centre[0] ** 2 + centre[2] ** 2,
                               centre[0] ** 2 + centre[1] ** 2])
    return abs(volume), np.abs(about_origin - shift).astype(np.float32)


def cook(points) -> Hull:
    """A hull from its point cloud: the convex hull's vertices (qhull's, in
    the cloud's order); past V_CAP of them, only the cloud's points that are
    farthest along one of 4 V_CAP spiral directions, the first V_CAP of
    those in the cloud's order, and their hull again; the face axes, the
    facets' unit normals taken in qhull's order, each left out where it is
    within 0.999 of parallel (either sign) to one taken before, at most
    F_CAP; then both padded by repeating the first."""
    from scipy.spatial import ConvexHull

    pts = np.asarray(points, np.float64).reshape(-1, 3)
    hull = ConvexHull(pts)
    if len(hull.vertices) > V_CAP:
        far = np.unique(np.argmax(pts[hull.vertices] @ _spiral(4 * V_CAP).T, axis=0))
        pts = pts[hull.vertices[far][:V_CAP]]
        hull = ConvexHull(pts)
    verts = pts[hull.vertices].astype(np.float32)
    normals = hull.equations[:, :3] / np.linalg.norm(hull.equations[:, :3], axis=1, keepdims=True)
    axes: List[np.ndarray] = []
    for n in normals:
        if all(abs(float(n @ m)) <= 0.999 for m in axes):
            axes.append(n)
        if len(axes) == F_CAP:
            break
    axes = np.asarray(axes, np.float32)
    volume, inertia = _mass_properties(np.asarray(hull.points, np.float64), hull.simplices,
                                       hull.equations[:, :3])
    nv, nf = len(verts), len(axes)
    return Hull(verts=np.concatenate([verts, np.repeat(verts[:1], V_CAP - nv, axis=0)]),
                axes=np.concatenate([axes, np.repeat(axes[:1], F_CAP - nf, axis=0)]),
                n_verts=nv, n_faces=nf, radius=float(np.linalg.norm(verts, axis=1).max()),
                volume=volume, inertia=inertia)


@dataclass
class Scene:
    """The level as data: entity 0 the camera, entity 1 the slab, entity
    2 + i hull i (actor slot i, model instance i)."""

    starts: np.ndarray     # f32 [n, 3] the hulls' start positions
    hulls: List[Hull]
    capacity: int          # entity, actor and model-instance slots
    window: int            # K
    camera: tuple          # (position, fov, near, far)
    sdf: dict              # the slab's field: "lo", "hi" (the box), "origin", "cell", "dims"


def build(config: dict, seed: int) -> Scene:
    """The scene of the configuration's ``args`` (num_hulls, capacity,
    window) from the seed: hull i is the i-th draw of 10 points U(-0.45,
    0.45)^3 from numpy's generator; the hulls stand in stacks of five, stack
    c = i // 5 at column c of an even square grid at 2 m centred on the
    origin (row-major, the grid's side the least even one that holds the
    stacks), the j-th of a stack 0.85 j + 0.8 m above the surface under the
    stack's centre (the slab's top inside it, else the ground), offset by
    +-0.125 m in x and -0.2 to 0.24 m in z as j goes; the camera level 4 m up,
    80 m past the farthest hull in z, 70 degrees, 0.3 to 300 m."""
    args = config["args"]
    n, cap, window = int(args["num_hulls"]), int(args["capacity"]), int(args["window"])
    (x0, x1), (_y0, top), (z0, z1) = (tuple(v) for v in np.stack(
        [config["sdf"]["lo"], config["sdf"]["hi"]], axis=1))
    rng = np.random.default_rng(int(seed))
    side = int(np.ceil(np.sqrt(np.ceil(n / STACK))))
    side += side % 2
    starts, hulls = [], []
    for i in range(n):
        stack, j = divmod(i, STACK)
        x = PITCH * (stack % side - (side - 1) / 2)
        z = PITCH * (stack // side - (side - 1) / 2)
        surface = top if (x0 < x < x1 and z0 < z < z1) else 0.0
        starts.append((x + 0.25 * (j % 2) - 0.125, surface + 0.8 + 0.85 * j,
                       z + 0.22 * (j // 2) - 0.2))
        hulls.append(cook(rng.uniform(-0.45, 0.45, (10, 3)).astype(np.float32)))
    camera = ((0.0, 4.0, max(p[2] for p in starts) + 80.0), np.float32(np.radians(70.0)),
              np.float32(0.3), np.float32(300.0))
    return Scene(np.asarray(starts, np.float32), hulls, cap, window, camera, dict(config["sdf"]))


def slab_field(sdf: dict) -> np.ndarray:
    """The slab's signed distance (negative inside) at the grid's nodes
    origin + (i, j, k) cell, f32 [nx, ny, nz]: outside, the distance to the
    box; inside, minus the distance to its nearest face."""
    lo, hi = np.asarray(sdf["lo"], np.float64), np.asarray(sdf["hi"], np.float64)
    origin, cell = np.asarray(sdf["origin"], np.float64), float(sdf["cell"])
    axes = [origin[a] + np.arange(int(sdf["dims"][a])) * cell for a in range(3)]
    p = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    q = np.abs(p - 0.5 * (lo + hi)) - 0.5 * (hi - lo)
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    return (outside + np.minimum(q.max(axis=-1), 0.0)).astype(np.float32)


class _Scenery(bb._Scenery):
    """The default reference's hierarchy and cull pass on this scene's
    layout: every entity a root (slot = entity), model instance i on hull i
    (entity 2 + i), camera 0 on entity 0, the renderer's 256 point-light
    slots empty."""

    def __init__(self, scene: Scene, device):
        self.device = dev = torch.device(device)
        n, cap = len(scene.hulls), scene.capacity
        self.levels = []
        alive = np.zeros(cap, bool)
        alive[:n + 2] = True
        self.alive = bb._t(alive, dev)
        mi = np.zeros(cap, np.int64)
        mi[:n] = np.arange(2, n + 2)
        mask = np.zeros(cap, bool)
        mask[:n] = True
        self.mi_index, self.mi_mask = bb._t(mi, dev), bb._t(mask, dev)
        self.mi_radius = torch.full((cap,), MODEL_RADIUS, dtype=torch.float32, device=dev)
        self.lod_dist = torch.full((4, cap), float("inf"), device=dev)
        _pos, self.fov, self.near, self.far = scene.camera
        self.cam_slot, self.aspect = 0, np.float32(16.0 / 9.0)
        self.pl_index = torch.zeros(256, dtype=torch.int64, device=dev)
        self.pl_mask = torch.zeros(256, dtype=torch.bool, device=dev)
        self.pl_range = torch.full((256,), 10.0, device=dev)


def _table(x, idx):
    """A per-body table x [C, J, NB] at per-world body indices idx [W, P]
    -> [W, C, J, P]."""
    w, p = idx.shape
    return x.index_select(-1, idx.reshape(-1)).reshape(x.shape[:-1] + (w, p)).movedim(-2, 0)


def _lerp(a, b, t):
    return a * (1 - t) + b * t


class Model(bb.Model):
    """The scene's constants on `device`, and its frame."""

    def __init__(self, scene: Scene, device):
        self.scene, self.device = scene, torch.device(device)
        dev = self.device
        n, nb, k = len(scene.hulls), scene.capacity, scene.window
        self.n, self.nb, self.K = n, nb, k
        self.view = _Scenery(scene, dev)
        occ = np.zeros(nb, bool)
        occ[:n] = True
        self.occ = bb._t(occ, dev)
        self.body_slots = torch.arange(2, n + 2, device=dev)
        self.body_cols = torch.arange(n, device=dev)
        verts = np.zeros((3, V_CAP, nb), np.float32)
        axes = np.zeros((3, F_CAP, nb), np.float32)
        axes[1] = 1.0
        vert_real = np.zeros((V_CAP, nb), bool)
        face_real = np.zeros((F_CAP, nb), bool)
        radius = np.zeros(nb, np.float32)
        inertia = np.ones((3, nb), np.float32)
        for i, h in enumerate(scene.hulls):
            verts[:, :, i], axes[:, :, i] = h.verts.T, h.axes.T
            vert_real[:h.n_verts, i], face_real[:h.n_faces, i] = True, True
            radius[i] = h.radius
            inertia[:, i] = h.inertia * (np.float32(MASS) / max(h.volume, 1e-9))
        self.verts, self.axes = bb._t(verts, dev), bb._t(axes, dev)
        self.vert_real, self.face_real = bb._t(vert_real, dev), bb._t(face_real, dev)
        self.radius = bb._t(radius, dev)
        self.inv_mass = bb._t(np.where(occ, 1.0 / np.float32(MASS), 0.0).astype(np.float32), dev)
        self.inv_inertia = bb._t(np.where(occ, 1.0 / np.maximum(inertia, np.float32(1e-9)), 0.0)
                                 .astype(np.float32), dev)
        self.gravity = bb._t(np.array(bb.GRAVITY, np.float32)[:, None], dev)
        fric = torch.full((1,), FRICTION, device=dev)
        self.pair_mu = torch.sqrt(torch.clamp_min(fric * fric, 0.0))
        self.ground_mu = torch.sqrt(torch.clamp_min(fric * bb.GROUND_FRICTION, 0.0))
        p = torch.arange(k * nb, device=dev)
        self.slot_rank = p % nb
        self.partner_rank = self.slot_rank + p // nb + 1
        self.slot_valid = self.partner_rank < nb
        self.partner_rank = torch.clamp_max(self.partner_rank, nb - 1)
        self.eye = torch.eye(3, device=dev)
        self.field = bb._t(slab_field(scene.sdf), dev)
        self.field_origin = bb._t(np.asarray(scene.sdf["origin"], np.float32), dev)
        self.field_cell = float(scene.sdf["cell"])
        self.ground_slots = PLANE_SLOTS + 2 * V_CAP

    # -- the start ------------------------------------------------------------------

    def start(self, worlds: int, generator: torch.Generator, rows=None) -> dict:
        """Every world as the scene is built, then the benchmark's per-world
        noise from `generator`, as ``banded_boxes.Model.start`` draws it."""
        sc, dev, nb, k = self.scene, self.device, self.nb, self.K
        cap, n = sc.capacity, self.n
        pos = np.zeros((3, cap), np.float32)
        pos[:, 0] = sc.camera[0]
        pos[:, 2:n + 2] = sc.starts.T
        rot = np.zeros((4, cap), np.float32)
        rot[3] = 1.0
        one = {"local.pos": bb._t(pos, dev), "local.rot": bb._t(rot, dev),
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
        bpos[:, :n] = sc.starts.T
        one.update({PH + "pos": bb._t(bpos, dev), PH + "rot": model.identity_quats(nb, dev),
                    PH + "vel": torch.zeros((3, nb), device=dev),
                    PH + "angvel": torch.zeros((3, nb), device=dev),
                    PH + "sleep": torch.zeros(nb, dtype=torch.int32, device=dev),
                    CARRY[0]: torch.zeros((bb.SWEEPS, 3, POINTS, k, nb), device=dev),
                    CARRY[1]: torch.zeros((3, self.ground_slots, nb), device=dev),
                    CARRY[2]: torch.full((bb.SWEEPS, nb), -1, dtype=torch.int32, device=dev)})
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

    # -- the shapes -----------------------------------------------------------------

    def bounds(self, pos, rot):
        """Each body's bounding sphere as bounds (lo, hi [W, 3, NB]); an empty
        slot's moved FAR along every axis."""
        far = torch.where(self.occ, 0.0, bb.FAR)
        r = self.radius.unsqueeze(-2)
        return pos - r + far, pos + r + far

    def world_verts(self, pos, rot):
        """Every slot's hull vertices in the world [W, 3, V, NB]."""
        return pos.unsqueeze(-2) + ops.qrot(rot.unsqueeze(-2), self.verts, -3)

    def sample(self, p):
        """The slab's field at points p [W, 3, M]: trilinear within the
        grid, each coordinate held to [0, n - 1.001] cells, plus the
        distance from p to the point so held (so that beyond the grid
        reads as far) -> [W, M]."""
        dims = self.field.shape
        cells = (p - self.field_origin.unsqueeze(-1)) / self.field_cell
        held = torch.stack([cells[:, a].clamp(0.0, dims[a] - 1.001) for a in range(3)], dim=1)
        beyond = (cells - held) * self.field_cell
        extra = torch.sqrt(torch.clamp_min(torch.sum(beyond * beyond, dim=1), 0.0))
        corner = torch.floor(held).to(torch.int64)
        t = held - corner
        flat = self.field.reshape(-1)

        def node(dx, dy, dz):
            return flat[((corner[:, 0] + dx) * dims[1] + (corner[:, 1] + dy)) * dims[2]
                        + (corner[:, 2] + dz)]

        x00 = _lerp(node(0, 0, 0), node(1, 0, 0), t[:, 0])
        x10 = _lerp(node(0, 1, 0), node(1, 1, 0), t[:, 0])
        x01 = _lerp(node(0, 0, 1), node(1, 0, 1), t[:, 0])
        x11 = _lerp(node(0, 1, 1), node(1, 1, 1), t[:, 0])
        return _lerp(_lerp(x00, x10, t[:, 1]), _lerp(x01, x11, t[:, 1]), t[:, 2]) + extra

    def gradient(self, p):
        """The field's unit gradient at p [W, 3, M]: central differences half
        a cell either side along each axis, normalised."""
        e = 0.5 * self.field_cell
        parts = []
        for a in range(3):
            hi = torch.cat([p[:, :a], p[:, a:a + 1] + e, p[:, a + 1:]], dim=1)
            lo = torch.cat([p[:, :a], p[:, a:a + 1] - e, p[:, a + 1:]], dim=1)
            parts.append((self.sample(hi) - self.sample(lo)) / (2.0 * e))
        g = torch.stack(parts, dim=1)
        return g / torch.sqrt(torch.clamp_min(torch.sum(g * g, dim=1), 1e-12)).unsqueeze(1)

    def ground(self, pos, rot):
        """The per-body ground stream [G, NB] slot by slot: the primitive
        plane slots (never active here), each vertex on the plane, each real
        vertex in the slab's field -> dict of point, normal [W, 3, G, NB],
        depth, active [W, G, NB]; and how far its decisions sit from their
        threshold [W] (each counted slot's depth)."""
        w, nb = pos.shape[0], self.nb
        vw = self.world_verts(pos, rot)                                  # [W, 3, V, NB]
        down = torch.zeros_like(vw)
        down[:, 1] = -1.0
        plane_depth = 0.0 - vw[:, 1]
        plane_on = self.occ.expand(w, V_CAP, nb)
        pts = vw.reshape(w, 3, V_CAP * nb)
        field_depth = (0.0 - self.sample(pts)).reshape(w, V_CAP, nb)
        field_normal = -self.gradient(pts).reshape(w, 3, V_CAP, nb)
        field_on = (self.vert_real & self.occ).expand(w, -1, -1)
        idle_pt = pos.unsqueeze(-2).expand(w, 3, PLANE_SLOTS, nb)
        idle_n = torch.zeros_like(idle_pt)
        idle_n[:, 1] = -1.0
        out = dict(point=torch.cat([idle_pt, vw, vw], dim=2),
                   normal=torch.cat([idle_n, down, field_normal], dim=2),
                   depth=torch.cat([torch.full((w, PLANE_SLOTS, nb), -1.0, device=self.device),
                                    plane_depth, field_depth], dim=1))
        on = torch.cat([torch.zeros((w, PLANE_SLOTS, nb), dtype=torch.bool, device=self.device),
                        plane_on, field_on], dim=1)
        out["active"] = (out["depth"] > 0.0) & on
        near = torch.where(on, out["depth"].double().abs(), float("inf"))
        return out, near.amin(dim=(-2, -1))

    def hull_pairs(self, pos, rot, a, b):
        """The separating-axis contacts of hull pairs (a, b [W, P] body
        indices) -> (point, normal [W, 3, k, P], depth [W, k, P]: depth -1
        where the least overlap is not positive; each pair's gap between its
        two least overlaps over distinct axes [W, P], float64)."""
        pa, pb = bb._at(pos, a), bb._at(pos, b)
        qa, qb = bb._at(rot, a).unsqueeze(-2), bb._at(rot, b).unsqueeze(-2)
        va, vb = ops.qrot(qa, _table(self.verts, a), -3), ops.qrot(qb, _table(self.verts, b), -3)
        fa, fb = ops.qrot(qa, _table(self.axes, a), -3), ops.qrot(qb, _table(self.axes, b), -3)
        d = pb - pa
        length = torch.sqrt(torch.clamp_min(torch.sum(d * d, dim=1), 1e-12))
        centre = (d / length.unsqueeze(1)).unsqueeze(2)
        cand = torch.cat([fa, fb, centre], dim=2)                        # [W, 3, 2F + 1, P]
        du = torch.sum(d.unsqueeze(2) * cand, dim=1)                     # [W, 2F + 1, P]
        u = cand * torch.where(du >= 0, 1.0, -1.0).unsqueeze(1)          # pointing a -> b
        reach_a = torch.amax(torch.einsum("wcvp,wcap->wvap", va, u), dim=1)
        reach_b = torch.amax(torch.einsum("wcvp,wcap->wvap", vb, -u), dim=1)
        overlap = reach_a + reach_b - torch.abs(du)
        best = torch.argmin(overlap, dim=1)
        least = torch.amin(overlap, dim=1)
        n = torch.gather(u, 2, best[:, None, None, :].expand(-1, 3, 1, -1)).squeeze(2)
        distinct = torch.cat([_table(self.face_real[None], a)[:, 0], _table(self.face_real[None], b)[:, 0],
                              torch.ones_like(least, dtype=torch.bool).unsqueeze(1)], dim=1)
        two = torch.topk(torch.where(distinct, overlap.double(), float("inf")), 2, dim=1,
                         largest=False).values
        gap = two[:, 1] - two[:, 0]
        # support planes along n: a's far side, b's near side
        n_v = n.unsqueeze(2)
        top_a = torch.sum(pa * n, dim=1) + torch.amax(torch.sum(va * n_v, dim=1), dim=1)
        bot_b = torch.sum(pb * n, dim=1) - torch.amax(torch.sum(vb * -n_v, dim=1), dim=1)
        wa, wb = pa.unsqueeze(2) + va, pb.unsqueeze(2) + vb
        depth_b = top_a.unsqueeze(1) - torch.sum(wb * n_v, dim=1)       # b's vertices behind a
        depth_a = torch.sum(wa * n_v, dim=1) - bot_b.unsqueeze(1)       # a's beyond b
        depth = torch.minimum(torch.cat([depth_b, depth_a], dim=1), least.unsqueeze(1))
        depth = torch.where(least.unsqueeze(1) > 0.0, depth, -1.0)
        pts = torch.cat([wb, wa], dim=2)
        dsort, idx = torch.sort(depth.transpose(1, 2), dim=-1, descending=True, stable=True)
        idx = idx[..., :POINTS].transpose(1, 2)                          # [W, k, P]
        point = torch.gather(pts, 2, idx.unsqueeze(1).expand(-1, 3, -1, -1))
        return point, n_v.expand(point.shape), dsort[..., :POINTS].transpose(1, 2), gap

    # -- the rigid bodies -----------------------------------------------------------

    def bodies(self, s, dt) -> None:
        pos, rot, vel, angvel = (s[PH + f] for f in ("pos", "rot", "vel", "angvel"))
        h = torch.clamp_max(dt, bb.MAX_DT)
        m = self.occ.unsqueeze(-2)
        decay = torch.exp(-bb.DAMPING * h)
        vel = torch.where(m, (vel + self.gravity * h) * decay, vel)
        angvel = torch.where(m, angvel * decay, angvel)
        w, nb, K = pos.shape[0], self.nb, self.K

        g, margin = self.ground(pos, rot)
        lo, hi = self.bounds(pos, rot)
        sweeps = self.sweeps(lo, hi)
        sets, pair_margin = self.pair_sets(pos, rot, lo, hi, sweeps)
        margin = torch.minimum(margin, pair_margin)
        n_active = (g["active"].sum(dim=(-2, -1))
                    + sum(c["active"].sum(dim=(-2, -1)) for c in sets)).to(torch.int32)
        certs = [self.certificate(order, key, wall, lo, hi) for order, _r, key, wall in sweeps]

        self.warm(sets, s)
        iiw = self.inv_inertia_world(rot)
        deg = g["active"].float().sum(dim=1).unsqueeze(1)
        for c in sets:
            act = c["active"].flatten(-2).unsqueeze(-2).float()
            deg = bb._add(bb._add(deg, c["a"].repeat(1, POINTS), act), c["b"].repeat(1, POINTS), act)
        deg = deg.squeeze(-2)
        ground = self.ground_contacts(g, pos, iiw, deg)
        ground["warm"] = [s[CARRY[1]][:, j].flatten(-2) for j in range(3)]  # by body
        for c in sets:
            self.pair_constants(c, pos, iiw, deg)
        vel, angvel = self.solve(vel, angvel, iiw, ground, sets)
        new_pos = pos + vel * h
        wq = torch.cat([angvel, torch.zeros_like(angvel[..., :1, :])], dim=bb.V)
        new_rot = ops.normalized(rot + ops.qmul(wq, rot, bb.V) * (0.5 * h), bb.V)
        pos = self.project(torch.where(m, new_pos, pos), ground, sets)
        rot = torch.where(m, new_rot, rot)
        calm = ((ops.dot(vel, vel, bb.V) < bb.SLEEP_V ** 2)
                & (ops.dot(angvel, angvel, bb.V) < bb.SLEEP_W ** 2))
        sleep = torch.where(calm & self.occ, s[PH + "sleep"] + 1, 0).to(torch.int32)
        asleep = (sleep >= bb.SLEEP_FRAMES).unsqueeze(-2)
        s.update({PH + "pos": pos, PH + "rot": rot, PH + "vel": torch.where(asleep, 0.0, vel),
                  PH + "angvel": torch.where(asleep, 0.0, angvel), PH + "sleep": sleep,
                  CARRY[0]: torch.stack([torch.stack(c["lam"], dim=1).reshape(
                      (w, 3, POINTS, K, nb)) for c in sets], dim=1),
                  CARRY[1]: torch.stack(ground["lam"], dim=1).reshape((w, 3, self.ground_slots, nb)),
                  CARRY[2]: torch.stack([r for _o, r, _k, _w in sweeps], dim=1).to(torch.int32),
                  COUNTERS[0]: n_active, COUNTERS[1]: sum(n for n, _g in certs)})
        miss_margin = torch.stack([g for _n, g in certs]).amin(dim=0)
        self._margins = (self.rank_margins(sweeps, lo), margin, miss_margin)

    def pair_sets(self, pos, rot, lo, hi, sweeps):
        """Each sweep's pair contacts: the next K bodies of each in its
        order, where both slots hold a hull, the bounds overlap and no
        earlier sweep's window holds the pair -> (one dict a sweep, as
        ``banded_boxes``; how far the contact decisions sit from their
        thresholds [W]: each held pair's bound test, each overlapping pair's
        depths and the gap between its two least overlaps)."""
        w, K = pos.shape[0], self.K
        occ = self.occ.expand(w, -1)
        sets = []
        margin = torch.full((w,), float("inf"), dtype=torch.float64, device=self.device)
        for s_i, (order, _rank, _key, _wall) in enumerate(sweeps):
            a, b, valid = self.pairs(order)
            lo_a, hi_a, lo_b, hi_b = bb._at(lo, a), bb._at(hi, a), bb._at(lo, b), bb._at(hi, b)
            overlap = ((lo_a <= hi_b) & (lo_b <= hi_a)).all(dim=bb.V)
            held = valid & bb._at(occ, a) & bb._at(occ, b)
            for _order, r_prev, _key, _wall in sweeps[:s_i]:
                held = held & ((bb._at(r_prev, b) - bb._at(r_prev, a)).abs() > K)
            point, normal, depth, gap = self.hull_pairs(pos, rot, a, b)
            both = held & overlap
            active = (depth > 0.0) & both.unsqueeze(-2)
            sets.append(dict(a=a, b=b, point=point, normal=normal, depth=depth, active=active))
            slack = torch.minimum(hi_b - lo_a, hi_a - lo_b).double().amin(dim=bb.V).abs()
            near = torch.where(both.unsqueeze(-2), depth.double().abs(), float("inf"))
            margin = torch.minimum(margin, torch.minimum(
                torch.where(held, slack, float("inf")).amin(dim=-1), near.amin(dim=(-2, -1))))
            margin = torch.minimum(margin, torch.where(both, gap, float("inf")).amin(dim=-1))
        return sets, margin

    def ground_contacts(self, g, pos, iiw, deg):
        """The per-body stream's constants, as ``banded_boxes`` sets the
        plane's, with each slot's own normal."""
        w, nb = pos.shape[0], self.nb
        slots = g["depth"].shape[1]
        body = torch.arange(nb, device=self.device).expand(w, -1).repeat(1, slots)
        c = dict(a=body, point=g["point"].flatten(-2), normal=g["normal"].flatten(-2),
                 depth=g["depth"].flatten(-2), active=g["active"].flatten(-2))
        c["r"] = c["point"] - bb._at(pos, body)
        c["t1"], c["t2"] = self.tangents(c["normal"])
        im, ii = bb._at(self.inv_mass.expand(w, -1), body), bb._at(iiw, body)
        for name, d in (("kn", c["normal"]), ("kt1", c["t1"]), ("kt2", c["t2"])):
            c[name] = torch.clamp_min(im + self.turn(c["r"], d, ii), 1e-9)
        dg = bb._at(deg, body)
        c["relax"] = torch.clamp_max(1.6 / torch.clamp_min(dg, 1.0), bb.RELAX)
        c["relax_p"] = torch.clamp_max(1.6 / torch.clamp_min(dg, 1.0), bb.PROJ_RELAX)
        c["k_lin"] = torch.clamp_min(im, 1e-9)
        c["mu"] = self.ground_mu
        return c
