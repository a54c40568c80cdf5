"""PhysicsModule + PhysicsSystem (counterpart of
``lumixengine_tpu/physics/module.py``), ported for the pruned broadphase
branch: dynamic sphere and box actors over a static candidate pair list
whose AABB-overlapping pairs are compacted into a fixed budget each frame,
ground-plane contacts, and the fused contact solve (kernel K2) with its
split-impulse projection.

One frame of ``update_parallel``: clamp dt to 1/20 s, integrate velocities,
build the ground stream and the compacted pair stream, gate the warm-start
impulses by pair identity, solve, integrate positions, add the projection's
dpos, update sleep. ``update`` writes the poses back to the entities' local
transforms. SAP/banded broadphases, convex/SDF/capsule shapes, static and
kinematic actors, joints, CCD, vehicles, controllers and heightfields raise
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from lumixengine_tpu_torch.engine.plugin import IModule, ISystem
from lumixengine_tpu_torch.engine.world import World, WorldState
from lumixengine_tpu_torch.ops import physics_ops as P
from lumixengine_tpu_torch.ops import solver as S
from lumixengine_tpu_torch.ops.physics_big import compact_pairs
from lumixengine_tpu_torch.utils.store import DenseStore

MOTION_STATIC = 0
MOTION_DYNAMIC = 1
MOTION_KINEMATIC = 2

MAX_LAYERS = 32
# above this many actor slots the reference switches to its SAP/banded
# broadphases, which are not ported
SAP_THRESHOLD = 256

_NOT_PORTED = ("distance_joint", "spherical_joint", "hinge_joint", "d6_joint",
               "physics_controller", "heightfield", "vehicle", "wheel", "mesh_collider",
               "instanced_cube", "instanced_mesh")


@dataclass
class PhysicsState:
    pos: torch.Tensor       # f32 [3, NB]
    rot: torch.Tensor       # f32 [4, NB]
    vel: torch.Tensor       # f32 [3, NB]
    angvel: torch.Tensor    # f32 [3, NB]
    sleep: torch.Tensor     # int32 [NB] calm-frame counter
    lam_n: torch.Tensor     # f32 [n_contact_slots] warm-start impulses
    lam_t1: torch.Tensor
    lam_t2: torch.Tensor
    pair_key: torch.Tensor  # int32 [pair_budget] a*NB+b per compacted slot, -1 empty
    counters: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "PhysicsState":
        return dataclasses.replace(self, **kw)


class PhysStatics:
    """Host constants of the pruned branch: pair list and budget, ground
    slots, per-contact materials, mass properties."""

    def __init__(self, module: "PhysicsModule"):
        w = module.world
        st = module.actors
        nb = st.capacity
        occupied = st.entity >= 0
        motion = np.asarray(st.data["motion"], np.int32)
        self.shape = np.asarray(st.data["shape"], np.int32)
        if np.any(occupied & (motion != MOTION_DYNAMIC)):
            raise NotImplementedError("static and kinematic actors are not ported")
        if np.any(occupied & ~np.isin(self.shape, (P.SHAPE_SPHERE, P.SHAPE_BOX))):
            raise NotImplementedError("only sphere and box actors are ported")
        if np.any(occupied & np.asarray(st.data["ccd"], bool)):
            raise NotImplementedError("CCD is not ported")
        if nb > SAP_THRESHOLD:
            raise NotImplementedError(
                f"{nb} actor slots: the SAP/banded broadphases (above {SAP_THRESHOLD}) are not ported")
        self.entity_slots = w.to_slots(st.entity)
        self.radius = np.asarray(st.data["radius"], np.float32)
        self.half_extents = np.asarray(st.data["half_extents"], np.float32).T.copy()  # [3,NB]
        self.layer = np.asarray(st.data["layer"], np.int32)
        friction = np.asarray(st.data["friction"], np.float32)
        restitution = np.asarray(st.data["restitution"], np.float32)
        mass = np.asarray(st.data["mass"], np.float32)

        self.nb = nb
        self.occupied = occupied
        self.dyn_mask = occupied & (motion == MOTION_DYNAMIC)
        self.inv_mass = np.where(self.dyn_mask, 1.0 / np.maximum(mass, 1e-6), 0.0).astype(np.float32)
        self.friction_body = friction.copy()
        self.restitution_body = restitution.copy()
        he = self.half_extents
        ib = np.zeros((3, nb), np.float32)
        for a in range(3):
            b_, c_ = (a + 1) % 3, (a + 2) % 3
            box_i = mass / 12.0 * ((2 * he[b_]) ** 2 + (2 * he[c_]) ** 2)
            sph_i = 0.4 * mass * self.radius**2
            ii = np.where(self.shape == P.SHAPE_BOX, box_i, sph_i)
            ib[a] = np.where(self.dyn_mask, 1.0 / np.maximum(ii, 1e-9), 0.0)
        self.inv_inertia_body = ib
        self.ground_plane = bool(module.system.ground_plane)

        # static candidate pairs: occupied, one dynamic, layer matrix allows
        lm_ = module.system.layer_matrix
        ii, jj = np.triu_indices(nb, k=1)
        keep = occupied[ii] & occupied[jj]
        keep &= (motion[ii] == MOTION_DYNAMIC) | (motion[jj] == MOTION_DYNAMIC)
        keep &= lm_[self.layer[ii], self.layer[jj]]
        self.pair_a = ii[keep].astype(np.int32)
        self.pair_b = jj[keep].astype(np.int32)
        self.pruned = len(self.pair_a) > module.pruned_threshold
        if not self.pruned:
            raise NotImplementedError(
                f"{len(self.pair_a)} candidate pairs: the all-pairs branch (at most "
                f"{module.pruned_threshold}) is not ported, only the pruned one")
        budget = module.pair_budget or max(128, 6 * int(np.sum(self.dyn_mask)))
        self.pair_budget = int(min(budget, len(self.pair_a)))

        # static contact slots: the ground stream; the compacted pair stream
        # is appended after it at run time
        ppp = module.points_per_pair
        gnd = module.ground_slots_per_body if self.ground_plane else 0
        self.contact_body_a = np.tile(np.arange(nb, dtype=np.int32), gnd)
        self.contact_body_b = np.full(gnd * nb, -1, np.int32)
        valid_b = self.contact_body_b >= 0
        fa = friction[self.contact_body_a]
        fb = np.where(valid_b, friction[np.maximum(self.contact_body_b, 0)],
                      module.system.ground_friction)
        self.friction = np.sqrt(np.maximum(fa * fb, 0.0)).astype(np.float32)
        ra = restitution[self.contact_body_a]
        rb = np.where(valid_b, restitution[np.maximum(self.contact_body_b, 0)],
                      module.system.ground_restitution)
        self.restitution = np.maximum(ra, rb).astype(np.float32)
        self.n_contact_slots = self.contact_body_a.shape[0] + ppp * self.pair_budget
        self._dev: Dict[str, SimpleNamespace] = {}

    def on(self, device, system: "PhysicsSystem") -> SimpleNamespace:
        """The statics as tensors on `device`, built once."""
        key = str(torch.device(device))
        if key not in self._dev:
            def t(a, dtype=None):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

            dyn_cols = np.nonzero(self.dyn_mask)[0]
            self._dev[key] = SimpleNamespace(
                dyn=t(self.dyn_mask), shape=t(self.shape, torch.int64), radius=t(self.radius),
                he=t(self.half_extents), inv_mass=t(self.inv_mass),
                inv_inertia_body=t(self.inv_inertia_body),
                pair_a=t(self.pair_a, torch.int64), pair_b=t(self.pair_b, torch.int64),
                friction_body=t(self.friction_body), restitution_body=t(self.restitution_body),
                friction=t(self.friction), restitution=t(self.restitution),
                gravity=t(system.gravity),
                dyn_cols=t(dyn_cols, torch.int64),
                dyn_slots=t(self.entity_slots[dyn_cols], torch.int64),
            )
        return self._dev[key]


class PhysicsModule(IModule):
    name = "physics"

    def __init__(self, world: World, system: "PhysicsSystem", max_actors: int = 256,
                 points_per_pair: int = 4, ground_slots_per_body: int = 4,
                 solver_iterations: int = 10, position_iterations: int = 3,
                 pair_budget: Optional[int] = None, pruned_threshold: int = 192,
                 pruned_margin: float = 0.05):
        super().__init__(world, system)
        self.pair_budget = pair_budget
        self.pruned_threshold = pruned_threshold
        self.pruned_margin = pruned_margin
        self.actors = DenseStore(max_actors, {
            "motion": ((), np.int32, MOTION_STATIC),
            "shape": ((), np.int32, P.SHAPE_SPHERE),
            "radius": ((), np.float32, 0.5),
            "half_extents": ((3,), np.float32, 0.5),
            "mass": ((), np.float32, 1.0),
            "friction": ((), np.float32, 0.5),
            "restitution": ((), np.float32, 0.0),
            "layer": ((), np.int32, 0),
            "ccd": ((), np.bool_, False),
        })
        self.points_per_pair = points_per_pair
        self.ground_slots_per_body = ground_slots_per_body
        self.solver_iterations = solver_iterations
        self.position_iterations = position_iterations
        self._statics: Optional[PhysStatics] = None
        self._statics_version = -1

    def component_types(self):
        return ["rigid_actor", *_NOT_PORTED]

    def create_component(self, entity: int, ctype: str, **props):
        if ctype != "rigid_actor":
            raise NotImplementedError(f"physics component {ctype!r} is not ported")
        self._statics = None
        motion = props.get("motion", "static")
        motion = {"static": MOTION_STATIC, "dynamic": MOTION_DYNAMIC,
                  "kinematic": MOTION_KINEMATIC}.get(motion, motion)
        shape = props.get("shape", "sphere")
        shape = {"sphere": P.SHAPE_SPHERE, "box": P.SHAPE_BOX, "capsule": P.SHAPE_CAPSULE,
                 "convex": P.SHAPE_CONVEX}.get(shape, shape)
        if shape == P.SHAPE_CONVEX:
            raise NotImplementedError("convex actors are not ported")
        self.actors.add(
            entity,
            motion=np.int32(motion),
            shape=np.int32(shape),
            radius=np.float32(float(props.get("radius", 0.5))),
            half_extents=np.asarray(props.get("half_extents", (0.5, 0.5, 0.5)), np.float32),
            mass=np.float32(props.get("mass", 1.0)),
            friction=np.float32(props.get("friction", 0.5)),
            restitution=np.float32(props.get("restitution", 0.0)),
            layer=np.int32(props.get("layer", 0)),
            ccd=np.bool_(props.get("ccd", False)),
        )

    def statics(self) -> PhysStatics:
        self.world._refresh_levels()
        if (self._statics is None or self._statics_version != self.world.topology_version
                or self._statics.ground_plane != bool(self.system.ground_plane)):
            self._statics = PhysStatics(self)
            self._statics_version = self.world.topology_version
        return self._statics

    def prepare_statics(self, device) -> None:
        self.statics().on(device, self.system)

    def device_state(self, device) -> PhysicsState:
        st = self.statics()
        nb = st.nb
        pos = np.zeros((3, nb), np.float32)
        rot = np.tile(np.array([[0.0], [0.0], [0.0], [1.0]], np.float32), (1, nb))
        for slot in range(self.actors.capacity):
            e = int(self.actors.entity[slot])
            if e >= 0:
                p, r, _ = self.world.get_global_transform(e)
                pos[:, slot] = p
                rot[:, slot] = r
        f32 = dict(dtype=torch.float32, device=device)
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return PhysicsState(
            pos=torch.as_tensor(pos, device=device), rot=torch.as_tensor(rot, device=device),
            vel=torch.zeros((3, nb), **f32), angvel=torch.zeros((3, nb), **f32),
            sleep=torch.zeros(nb, dtype=torch.int32, device=device),
            lam_n=torch.zeros(st.n_contact_slots, **f32),
            lam_t1=torch.zeros(st.n_contact_slots, **f32),
            lam_t2=torch.zeros(st.n_contact_slots, **f32),
            pair_key=torch.full((st.pair_budget,), -1, dtype=torch.int32, device=device),
            counters={"active_contacts": zero, "sap_window_miss": zero.clone(),
                      "pruned_pair_miss": zero.clone()},
        )

    # -- phases -----------------------------------------------------------------

    def _compacted_pair_stream(self, st: PhysStatics, d, pos, rot):
        """Test the candidate pairs for AABB overlap, compact the overlapping
        ones into the budget (stable order) and run the narrowphase on them.
        Returns (Contacts, per-slot friction, restitution, overflow, pair_key)."""
        k = self.points_per_pair
        nb = pos.shape[-1]
        mn, mx = P.world_aabb(pos, rot, d.shape, d.radius, d.he)
        m = self.pruned_margin
        amn, amx = P.take_vecs(mn, d.pair_a), P.take_vecs(mx, d.pair_a)
        bmn, bmx = P.take_vecs(mn, d.pair_b), P.take_vecs(mx, d.pair_b)
        overlap = torch.all((amn <= bmx + m) & (bmn <= amx + m), dim=-2)  # [.., P]
        cpa, cpb, valid, miss = compact_pairs(d.pair_a, d.pair_b, overlap, st.pair_budget)
        pair_key = torch.where(valid, cpa * nb + cpb, -1).to(torch.int32)
        cc = P.pair_contacts(pos, rot, d.shape, d.radius, d.he, cpa.to(torch.int64),
                             cpb.to(torch.int64), points_per_pair=k)
        cc = cc._replace(active=cc.active & valid.tile((k,)))
        fa, fb = d.friction_body[cc.body_a], d.friction_body[cc.body_b]
        cfric = torch.sqrt(torch.clamp_min(fa * fb, 0.0))
        crest = torch.maximum(d.restitution_body[cc.body_a], d.restitution_body[cc.body_b])
        return cc, cfric, crest, miss, pair_key

    def _contact_stage(self, state: WorldState, dt):
        """Everything before the solve: the clamped dt, integrated velocities,
        the contact set with its materials, the world inverse inertia and the
        gated warm-start impulses."""
        st = self.statics()
        sys = self.system
        ms: PhysicsState = state.modules[self.name]
        d = st.on(ms.pos.device, sys)
        dt_c = torch.clamp_max(torch.as_tensor(dt, dtype=torch.float32, device=ms.pos.device),
                               1.0 / 20.0)
        pos, rot = ms.pos, ms.rot
        vel, angvel = P.integrate_velocities(ms.vel, ms.angvel, dt_c, d.gravity,
                                             sys.linear_damping, sys.angular_damping, d.dyn)
        cc, cfric, crest, miss, pair_key = self._compacted_pair_stream(st, d, pos, rot)
        if st.ground_plane:
            gc = P.ground_contacts(pos, rot, d.shape, d.radius, d.he, d.dyn,
                                   ground_y=sys.ground_y, slots_per_body=self.ground_slots_per_body)
            contacts = P.concat_contacts(gc, cc)
            batch = cfric.shape[:-1]
            fric = torch.cat([d.friction.expand(batch + d.friction.shape), cfric], dim=-1)
            rest = torch.cat([d.restitution.expand(batch + d.restitution.shape), crest], dim=-1)
        else:
            contacts, fric, rest = cc, cfric, crest
        iiw = P.inv_inertia_world_diag(rot, d.inv_inertia_body)
        # compacted-slot identity gate: compaction renumbers slots when the
        # overlap set churns, and another pair's impulse must not carry over
        k = self.points_per_pair
        prefix = st.n_contact_slots - k * st.pair_budget
        same = (pair_key == ms.pair_key).tile((k,))
        keep = torch.cat([torch.ones(same.shape[:-1] + (prefix,), dtype=torch.bool,
                                     device=same.device), same], dim=-1)
        warm = tuple(torch.where(keep, w, 0.0) for w in (ms.lam_n, ms.lam_t1, ms.lam_t2))
        return SimpleNamespace(dt_c=dt_c, pos=pos, rot=rot, vel=vel, angvel=angvel,
                               contacts=contacts, fric=fric, rest=rest, iiw=iiw, warm=warm,
                               miss=miss, pair_key=pair_key, d=d)

    def _solver_kwargs(self):
        # position projection owns depth correction: no velocity bias on top
        return dict(baumgarte=0.0 if self.position_iterations > 0 else 0.2)

    def solver_problem(self, state: WorldState, dt) -> S.ContactProblem:
        """K2's operands for this frame (the contact set the step would
        solve), for kernel checks against the plain version."""
        c = self._contact_stage(state, dt)
        return S.prologue(c.pos, c.vel, c.angvel, c.contacts, c.d.inv_mass, c.iiw, c.dt_c,
                          c.fric, c.rest, warm_lambdas=c.warm, **self._solver_kwargs())

    def update_parallel(self, state: WorldState, dt) -> WorldState:
        ms: PhysicsState = state.modules[self.name]
        c = self._contact_stage(state, dt)
        vel, angvel, lams, dpos = S.solve_contacts_fused(
            c.pos, c.vel, c.angvel, c.contacts, c.d.inv_mass, c.iiw, c.dt_c, c.fric, c.rest,
            iterations=self.solver_iterations, position_iterations=self.position_iterations,
            warm_lambdas=c.warm, **self._solver_kwargs())
        n_active = torch.sum(c.contacts.active, dim=-1).to(torch.int32)
        pos, rot = P.integrate_positions(c.pos, c.rot, vel, angvel, c.dt_c, c.d.dyn)
        if self.position_iterations > 0:
            pos = pos + dpos  # dpos depends only on the contact set
        vel, angvel, sleep, _ = P.update_sleep(vel, angvel, ms.sleep, c.d.dyn)
        ms = ms.replace(pos=pos, rot=rot, vel=vel, angvel=angvel, sleep=sleep,
                        lam_n=lams[0], lam_t1=lams[1], lam_t2=lams[2], pair_key=c.pair_key,
                        counters={"active_contacts": n_active, "sap_window_miss": c.miss,
                                  "pruned_pair_miss": c.miss})
        return state.replace(modules={**state.modules, self.name: ms})

    def update(self, state: WorldState, dt) -> WorldState:
        """Write the dynamic bodies' poses back into their entities' local
        transforms (propagation follows)."""
        ms: PhysicsState = state.modules[self.name]
        d = self.statics().on(ms.pos.device, self.system)
        if d.dyn_cols.numel() == 0:
            return state
        local = state.local.replace(
            pos=state.local.pos.index_copy(-1, d.dyn_slots, ms.pos.index_select(-1, d.dyn_cols)),
            rot=state.local.rot.index_copy(-1, d.dyn_slots, ms.rot.index_select(-1, d.dyn_cols)),
        )
        return state.replace(local=local)


class PhysicsSystem(ISystem):
    """Global physics config: gravity, layer matrix, ground plane, damping."""

    name = "physics_system"

    def __init__(self, engine, gravity=(0.0, -9.81, 0.0)):
        super().__init__(engine)
        self.gravity = np.asarray(gravity, np.float32)
        self.layer_matrix = np.ones((MAX_LAYERS, MAX_LAYERS), bool)
        self.ground_plane = True
        self.ground_y = 0.0
        self.ground_friction = 0.6
        self.ground_restitution = 0.0
        self.linear_damping = 0.05
        self.angular_damping = 0.05

    def create_modules(self, world: World) -> PhysicsModule:
        caps = getattr(self.engine, "module_capacities", {})
        return PhysicsModule(world, self, max_actors=caps.get("actors", 256))
