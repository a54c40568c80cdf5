"""PhysicsModule + PhysicsSystem (counterpart of
``lumixengine_tpu/physics/module.py``): rigid actors with sphere, box and
capsule shapes, dynamic, static or kinematic, the collision layer matrix,
the ground plane, the four joint types and sleeping, under the three
broadphase branches the reference's ``broadphase="auto"`` picks:

* all-pairs (at most ``pruned_threshold`` candidate pairs): the static pair
  list, every pair in the contact stream each frame;
* pruned (more candidate pairs): the AABB-overlapping pairs compacted into a
  fixed budget each frame, their warm-start impulses gated by pair identity;
* banded (above ``sap_threshold`` actor slots): the multi-sweep rank-space
  pipeline of ``ops/physics_banded.py``, with its warm-start carry and its
  per-frame window certificate.

One frame of ``update_parallel``: clamp dt to 1/20 s, static and kinematic
bodies take their entity's world pose, integrate velocities, build the
ground and pair streams, solve them (kernel K2 in the first two branches,
the banded Jacobi solve in the third), the joints, integrate positions, add
the projection's dpos, update sleep. ``update`` writes the dynamic bodies'
poses back to their entities' local transforms. ``broadphase="sap"``,
convex hulls, SDF mesh colliders, heightfields, instanced statics, CCD,
vehicles, character controllers and the raycast/sweep queries raise
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from lumixengine_tpu_torch.core import host_math as hm
from lumixengine_tpu_torch.core import math as lm
from lumixengine_tpu_torch.engine.plugin import IModule, ISystem
from lumixengine_tpu_torch.engine.world import World, WorldState
from lumixengine_tpu_torch.ops import physics_banded as PBD
from lumixengine_tpu_torch.ops import physics_ops as P
from lumixengine_tpu_torch.ops import solver as S
from lumixengine_tpu_torch.ops.physics_big import compact_pairs
from lumixengine_tpu_torch.utils.store import DenseStore

MOTION_STATIC = 0
MOTION_DYNAMIC = 1
MOTION_KINEMATIC = 2

MAX_LAYERS = 32
AX = -2
JOINT_TYPES = {"distance_joint": 0, "spherical_joint": 1, "hinge_joint": 2, "d6_joint": 3}

_NOT_PORTED = ("physics_controller", "heightfield", "vehicle", "wheel", "mesh_collider",
               "instanced_cube", "instanced_mesh")


@dataclass
class PhysicsState:
    pos: torch.Tensor       # f32 [3, NB]
    rot: torch.Tensor       # f32 [4, NB]
    vel: torch.Tensor       # f32 [3, NB]
    angvel: torch.Tensor    # f32 [3, NB]
    sleep: torch.Tensor     # int32 [NB] calm-frame counter
    lam_n: torch.Tensor     # f32 [n_contact_slots] warm-start impulses; [0] banded
    lam_t1: torch.Tensor
    lam_t2: torch.Tensor
    pair_key: torch.Tensor  # int32 [pair_budget] a*NB+b per compacted slot, -1 empty; [0] unpruned
    # banded warm-start carry (physics_banded.match_warm_lams): pair lambdas per
    # sweep in its previous rank space, ground lambdas in body order, and the
    # previous body → rank maps; [0]-sized outside the banded branch
    sap_lam: torch.Tensor   # f32 [S, 3, k, K, NB]
    sap_glam: torch.Tensor  # f32 [3, G, NB]
    sap_rank: torch.Tensor  # int32 [S, NB], -1 = cold
    counters: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "PhysicsState":
        return dataclasses.replace(self, **kw)


class PhysStatics:
    """Host constants: mass properties, the branch and its pair list, the
    static contact-slot layout [ground | pairs] with its materials, and the
    joints."""

    def __init__(self, module: "PhysicsModule"):
        w = module.world
        st = module.actors
        nb = st.capacity
        occupied = st.entity >= 0
        motion = np.asarray(st.data["motion"], np.int32)
        self.shape = np.asarray(st.data["shape"], np.int32)
        if np.any(occupied & np.asarray(st.data["ccd"], bool)):
            raise NotImplementedError("CCD (PhysicsModule._ccd_clamp) is not ported")
        if module.broadphase == "sap":
            raise NotImplementedError(
                "broadphase='sap' (PhysicsModule._sap_solve on physics_big.sap_pairs, "
                "solve_contacts_dynamic, project_positions_dynamic) is not ported")
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
        self.kin_mask = occupied & (motion != MOTION_DYNAMIC)
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
        self.sap = module.sap_active()
        self.any_caps = bool(np.any(occupied & (self.shape == P.SHAPE_CAPSULE)))

        ppp = module.points_per_pair
        self.pruned = False
        if self.sap:
            self.pair_a = self.pair_b = np.zeros(0, np.int32)
        else:
            # static candidate pairs: occupied, one dynamic, layer matrix allows
            lm_ = module.system.layer_matrix
            ii, jj = np.triu_indices(nb, k=1)
            keep = occupied[ii] & occupied[jj]
            keep &= (motion[ii] == MOTION_DYNAMIC) | (motion[jj] == MOTION_DYNAMIC)
            keep &= lm_[self.layer[ii], self.layer[jj]]
            self.pair_a = ii[keep].astype(np.int32)
            self.pair_b = jj[keep].astype(np.int32)
            self.pruned = module.broadphase == "pruned" or (
                module.broadphase == "auto" and len(self.pair_a) > module.pruned_threshold)
            if self.pruned:
                budget = module.pair_budget or max(128, 6 * int(np.sum(self.dyn_mask)))
                self.pair_budget = int(min(budget, len(self.pair_a)))
            # static contact slots [ground | pairs]; in the pruned branch the
            # compacted pair stream is appended at run time instead
            gnd = module.ground_slots_per_body if self.ground_plane else 0
            parts_a = [np.tile(np.arange(nb, dtype=np.int32), gnd)]
            parts_b = [np.full(gnd * nb, -1, np.int32)]
            if not self.pruned:
                parts_a.append(np.tile(self.pair_a, ppp))
                parts_b.append(np.tile(self.pair_b, ppp))
            self.contact_body_a = np.concatenate(parts_a)
            self.contact_body_b = np.concatenate(parts_b)
            valid_b = self.contact_body_b >= 0
            fa = friction[self.contact_body_a]
            fb = np.where(valid_b, friction[np.maximum(self.contact_body_b, 0)],
                          module.system.ground_friction)
            self.friction = np.sqrt(np.maximum(fa * fb, 0.0)).astype(np.float32)
            ra = restitution[self.contact_body_a]
            rb = np.where(valid_b, restitution[np.maximum(self.contact_body_b, 0)],
                          module.system.ground_restitution)
            self.restitution = np.maximum(ra, rb).astype(np.float32)
            self.n_contact_slots = self.contact_body_a.shape[0] + (
                ppp * self.pair_budget if self.pruned else 0)

        # joints: endpoint slots and parameters, [.., NJ]
        j = module.joints
        jo = j.entity >= 0
        jt = np.asarray(j.data["jtype"], np.int32)[jo]

        def jcol(name, dtype=np.float32):
            return np.asarray(j.data[name], dtype)[jo]

        self.joint_type = jt
        self.joint_a, self.joint_b = jcol("body_a", np.int32), jcol("body_b", np.int32)
        self.joint_len = jcol("length")
        self.joint_anchor_a = jcol("anchor_a").T.copy()
        self.joint_anchor_b = jcol("anchor_b").T.copy()
        self.joint_axis = jcol("axis").T.copy()
        self.joint_min_dist, self.joint_max_dist = jcol("min_distance"), jcol("max_distance")
        self.joint_limit_on = jcol("limit_on", np.int32)
        self.joint_limit_min, self.joint_limit_max = jcol("limit_min"), jcol("limit_max")
        self.joint_drive_on = jcol("drive_on", np.int32)
        self.joint_drive_vel, self.joint_drive_force = jcol("drive_velocity"), jcol("drive_force")
        self.joint_rest_rel = jcol("rest_rel_rot").T.copy()
        # d6 per-axis motions (frame-A axes); the point joints lock every
        # linear axis and no angular one
        lin = jcol("d6_linear", np.int32).T
        ang = jcol("d6_angular", np.int32).T
        is_d6 = jt == 3
        self.joint_lin_mask = np.where(is_d6[None, :], lin, 1).astype(np.float32)
        self.joint_ang_mask = np.where(is_d6[None, :], ang, 0).astype(np.float32)
        self.has_d6_config = bool(is_d6.any() and (
            (lin[:, is_d6] == 0).any() or (ang[:, is_d6] == 1).any()))
        self._dev: Dict[str, SimpleNamespace] = {}

    def on(self, device, system: "PhysicsSystem") -> SimpleNamespace:
        """The statics as tensors on `device`, built once."""
        key = str(torch.device(device))
        if key not in self._dev:
            def t(a, dtype=None):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

            i64 = torch.int64
            dyn_cols = np.nonzero(self.dyn_mask)[0]
            d = SimpleNamespace(
                dyn=t(self.dyn_mask), occ=t(self.occupied), kin=t(self.kin_mask),
                has_kin=bool(self.kin_mask.any()),
                eidx=t(np.maximum(self.entity_slots, 0), i64),
                shape=t(self.shape, i64), radius=t(self.radius), he=t(self.half_extents),
                layer=t(self.layer, i64), inv_mass=t(self.inv_mass),
                inv_inertia_body=t(self.inv_inertia_body),
                pair_a=t(self.pair_a, i64), pair_b=t(self.pair_b, i64),
                friction_body=t(self.friction_body), restitution_body=t(self.restitution_body),
                gravity=t(system.gravity), layer_matrix=t(system.layer_matrix.reshape(-1)),
                dyn_cols=t(dyn_cols, i64), dyn_slots=t(self.entity_slots[dyn_cols], i64),
                joint_a=t(self.joint_a, i64), joint_b=t(self.joint_b, i64),
                joint_is_dist=t(self.joint_type == 0), joint_is_d6=t(self.joint_type == 3),
                joint_len=t(self.joint_len), joint_anchor_a=t(self.joint_anchor_a),
                joint_anchor_b=t(self.joint_anchor_b), joint_axis=t(self.joint_axis),
                joint_min_dist=t(self.joint_min_dist), joint_max_dist=t(self.joint_max_dist),
                joint_has_band=t((self.joint_max_dist > 0).astype(np.float32)),
                joint_limit_on=t(self.joint_limit_on.astype(np.float32)),
                joint_limit_min=t(self.joint_limit_min), joint_limit_max=t(self.joint_limit_max),
                joint_drive_on=t(self.joint_drive_on.astype(np.float32)),
                joint_drive_vel=t(self.joint_drive_vel),
                joint_drive_force=t(self.joint_drive_force), joint_rest_rel=t(self.joint_rest_rel),
                joint_lin_mask=t(self.joint_lin_mask), joint_ang_mask=t(self.joint_ang_mask),
                eye=torch.eye(3, dtype=torch.float32, device=device),
            )
            if not self.sap:
                d.contact_body_a = t(self.contact_body_a, i64)
                d.contact_body_b = t(self.contact_body_b, i64)
                d.friction, d.restitution = t(self.friction), t(self.restitution)
            self._dev[key] = d
        return self._dev[key]


def _scatter(x, idx, nb: int):
    """x [..., c, NJ] summed into the bodies idx [NJ] → [..., c, NB]."""
    return torch.zeros(x.shape[:-1] + (nb,), dtype=x.dtype, device=x.device).index_add_(-1, idx, x)


class PhysicsModule(IModule):
    name = "physics"

    def __init__(self, world: World, system: "PhysicsSystem", max_actors: int = 256,
                 max_joints: int = 64, points_per_pair: int = 4, ground_slots_per_body: int = 4,
                 solver_iterations: int = 10, position_iterations: int = 3,
                 broadphase: str = "auto", sap_neighbors: int = 16, sap_threshold: int = 256,
                 sap_sweeps: int = 4, pair_budget: Optional[int] = None,
                 pruned_threshold: int = 192, pruned_margin: float = 0.05):
        super().__init__(world, system)
        # "auto": banded above sap_threshold actor slots, else pruned above
        # pruned_threshold candidate pairs, else all-pairs; "allpairs",
        # "pruned" and "banded" force a branch ("sap" is not ported)
        self.broadphase = broadphase
        self.sap_neighbors = sap_neighbors
        self.sap_threshold = sap_threshold
        self.sap_sweeps = sap_sweeps
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
        self.joints = DenseStore(max_joints, {
            "body_a": ((), np.int32, -1), "body_b": ((), np.int32, -1),
            "ent_a": ((), np.int32, -1), "ent_b": ((), np.int32, -1),
            "jtype": ((), np.int32, 0),        # 0 distance, 1 spherical, 2 hinge, 3 d6
            "length": ((), np.float32, 1.0),
            "min_distance": ((), np.float32, 0.0),   # a [min, max] band when max > 0
            "max_distance": ((), np.float32, 0.0),
            "anchor_a": ((3,), np.float32, 0.0),
            "anchor_b": ((3,), np.float32, 0.0),
            "axis": ((3,), np.float32, (0.0, 1.0, 0.0)),
            "limit_on": ((), np.int32, 0),
            "limit_min": ((), np.float32, 0.0),
            "limit_max": ((), np.float32, 0.0),
            "drive_on": ((), np.int32, 0),
            "drive_velocity": ((), np.float32, 0.0),
            "drive_force": ((), np.float32, 1e9),
            "rest_rel_rot": ((4,), np.float32, (0.0, 0.0, 0.0, 1.0)),  # hinge angle reference
            "d6_linear": ((3,), np.int32, 1),      # 1 locked, 0 free, frame-A axes
            "d6_angular": ((3,), np.int32, 0),
        })
        self.points_per_pair = points_per_pair
        self.ground_slots_per_body = ground_slots_per_body
        self.solver_iterations = solver_iterations
        self.position_iterations = position_iterations
        self._statics: Optional[PhysStatics] = None
        self._statics_version = -1

    def component_types(self):
        return ["rigid_actor", *JOINT_TYPES, *_NOT_PORTED]

    def create_component(self, entity: int, ctype: str, **props):
        if ctype in JOINT_TYPES:
            return self._create_joint(entity, JOINT_TYPES[ctype], props)
        if ctype != "rigid_actor":
            raise NotImplementedError(f"physics component {ctype!r} is not ported")
        self.invalidate_statics()
        motion = props.get("motion", "static")
        motion = {"static": MOTION_STATIC, "dynamic": MOTION_DYNAMIC,
                  "kinematic": MOTION_KINEMATIC}.get(motion, motion)
        shape = props.get("shape", "sphere")
        shape = {"sphere": P.SHAPE_SPHERE, "box": P.SHAPE_BOX, "capsule": P.SHAPE_CAPSULE,
                 "convex": P.SHAPE_CONVEX}.get(shape, shape)
        if shape == P.SHAPE_CONVEX:
            raise NotImplementedError("convex actors (hull cooking, convex_ops) are not ported")
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

    def _create_joint(self, entity: int, jtype: int, props):
        self.invalidate_statics()
        ea, eb = int(props["body_a"]), int(props["body_b"])
        _, ra, _ = self.world.get_global_transform(ea)
        _, rb, _ = self.world.get_global_transform(eb)
        self.joints.add(
            entity, body_a=np.int32(self.actors.slot_of(ea)),
            body_b=np.int32(self.actors.slot_of(eb)), ent_a=np.int32(ea), ent_b=np.int32(eb),
            jtype=np.int32(jtype),
            length=np.float32(props.get("length", 1.0)),
            min_distance=np.float32(props.get("min_distance", 0.0)),
            max_distance=np.float32(props.get("max_distance", 0.0)),
            anchor_a=np.asarray(props.get("anchor_a", (0.0,) * 3), np.float32),
            anchor_b=np.asarray(props.get("anchor_b", (0.0,) * 3), np.float32),
            axis=np.asarray(props.get("axis", (0.0, 1.0, 0.0)), np.float32),
            limit_on=np.int32(1 if "limit" in props else 0),
            limit_min=np.float32(props.get("limit", (0.0, 0.0))[0]),
            limit_max=np.float32(props.get("limit", (0.0, 0.0))[1]),
            drive_on=np.int32(1 if "drive_velocity" in props else 0),
            drive_velocity=np.float32(props.get("drive_velocity", 0.0)),
            drive_force=np.float32(props.get("drive_force", 1e9)),
            rest_rel_rot=np.asarray(hm.quat_mul(hm.quat_conjugate(ra), rb), np.float32),
            d6_linear=np.asarray(props.get("linear_motion", (1, 1, 1)), np.int32),
            d6_angular=np.asarray(props.get("angular_motion", (0, 0, 0)), np.int32))

    def sap_active(self) -> bool:
        """True for the large-world branch (no static pair list)."""
        if self.broadphase == "auto":
            return self.actors.capacity > self.sap_threshold
        return self.broadphase in ("sap", "banded")

    def invalidate_statics(self):
        self._statics = None

    def statics(self) -> PhysStatics:
        self.world._refresh_levels()
        if (self._statics is None or self._statics_version != self.world.topology_version
                or self._statics.ground_plane != bool(self.system.ground_plane)):
            self._statics = PhysStatics(self)
            self._statics_version = self.world.topology_version
        return self._statics

    def prepare_statics(self, device) -> None:
        self.statics().on(device, self.system)

    def _sweep_count(self) -> int:
        ns = self.sap_sweeps
        return ns if ns in (1, 2) else (5 if ns >= 5 else 4)

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
        i32 = dict(dtype=torch.int32, device=device)
        n_lam = 0 if st.sap else st.n_contact_slots
        if st.sap:
            n_s, k, K = self._sweep_count(), self.points_per_pair, self.sap_neighbors
            sap_lam = torch.zeros((n_s, 3, k, K, nb), **f32)
            g = self.ground_slots_per_body if st.ground_plane else 0
            sap_glam = torch.zeros((3, g, nb), **f32)
            sap_rank = torch.full((n_s, nb), -1, **i32)
        else:
            sap_lam, sap_glam, sap_rank = torch.zeros(0, **f32), torch.zeros(0, **f32), \
                torch.zeros(0, **i32)
        zero = torch.zeros((), **i32)
        return PhysicsState(
            pos=torch.as_tensor(pos, device=device), rot=torch.as_tensor(rot, device=device),
            vel=torch.zeros((3, nb), **f32), angvel=torch.zeros((3, nb), **f32),
            sleep=torch.zeros(nb, **i32),
            lam_n=torch.zeros(n_lam, **f32), lam_t1=torch.zeros(n_lam, **f32),
            lam_t2=torch.zeros(n_lam, **f32),
            pair_key=torch.full((st.pair_budget if st.pruned else 0,), -1, **i32),
            sap_lam=sap_lam, sap_glam=sap_glam, sap_rank=sap_rank,
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
                             cpb.to(torch.int64), points_per_pair=k, any_caps=st.any_caps)
        cc = cc._replace(active=cc.active & valid.tile((k,)))
        fa, fb = d.friction_body[cc.body_a], d.friction_body[cc.body_b]
        cfric = torch.sqrt(torch.clamp_min(fa * fb, 0.0))
        crest = torch.maximum(d.restitution_body[cc.body_a], d.restitution_body[cc.body_b])
        return cc, cfric, crest, miss, pair_key

    def _poses(self, state: WorldState, d):
        """Body poses for this frame: static and kinematic bodies take their
        entity's world transform."""
        ms: PhysicsState = state.modules[self.name]
        if not d.has_kin:
            return ms.pos, ms.rot
        pos = torch.where(d.kin, state.world.pos.index_select(-1, d.eidx), ms.pos)
        rot = torch.where(d.kin, state.world.rot.index_select(-1, d.eidx), ms.rot)
        return pos, rot

    def _contact_stage(self, state: WorldState, dt):
        """Everything before the contact solve of the all-pairs and pruned
        branches: the clamped dt, the poses, integrated velocities, the
        contact set (None when there is no stream) with its materials, the
        world inverse inertia and the warm-start impulses."""
        st = self.statics()
        sys = self.system
        ms: PhysicsState = state.modules[self.name]
        d = st.on(ms.pos.device, sys)
        dt_c = torch.clamp_max(torch.as_tensor(dt, dtype=torch.float32, device=ms.pos.device),
                               1.0 / 20.0)
        pos, rot = self._poses(state, d)
        vel, angvel = P.integrate_velocities(ms.vel, ms.angvel, dt_c, d.gravity,
                                             sys.linear_damping, sys.angular_damping, d.dyn)
        gc = None
        if st.ground_plane:
            gc = P.ground_contacts(pos, rot, d.shape, d.radius, d.he, d.dyn,
                                   ground_y=sys.ground_y, slots_per_body=self.ground_slots_per_body,
                                   any_caps=st.any_caps)
        c = SimpleNamespace(dt_c=dt_c, pos=pos, rot=rot, vel=vel, angvel=angvel, gc=gc, d=d,
                            contacts=None, miss=None, pair_key=ms.pair_key)
        if st.sap:
            return c
        batch = pos.shape[:-2]
        warm = (ms.lam_n, ms.lam_t1, ms.lam_t2)
        if st.pruned:
            cc, cfric, crest, c.miss, c.pair_key = self._compacted_pair_stream(st, d, pos, rot)
            if gc is not None:
                contacts = P.concat_contacts(gc, cc)
                fric = torch.cat([d.friction.expand(batch + d.friction.shape), cfric], dim=-1)
                rest = torch.cat([d.restitution.expand(batch + d.restitution.shape), crest], dim=-1)
            else:
                contacts, fric, rest = cc, cfric, crest
            # compacted-slot identity gate: compaction renumbers slots when the
            # overlap set churns, and another pair's impulse must not carry over
            k = self.points_per_pair
            prefix = st.n_contact_slots - k * st.pair_budget
            same = (c.pair_key == ms.pair_key).tile((k,))
            keep = torch.cat([torch.ones(same.shape[:-1] + (prefix,), dtype=torch.bool,
                                         device=same.device), same], dim=-1)
            warm = tuple(torch.where(keep, w, 0.0) for w in warm)
        else:
            streams = [] if gc is None else [gc]
            if len(st.pair_a):
                streams.append(P.pair_contacts(pos, rot, d.shape, d.radius, d.he, d.pair_a,
                                               d.pair_b, points_per_pair=self.points_per_pair,
                                               any_caps=st.any_caps))
            if not streams:
                return c
            contacts = streams[0] if len(streams) == 1 else P.concat_contacts(*streams)
            fric, rest = d.friction, d.restitution
        c.contacts, c.fric, c.rest, c.warm = contacts, fric, rest, warm
        c.iiw = P.inv_inertia_world_diag(rot, d.inv_inertia_body)
        return c

    def _solver_kwargs(self):
        # position projection owns depth correction: no velocity bias on top
        return dict(baumgarte=0.0 if self.position_iterations > 0 else 0.2)

    def solver_problem(self, state: WorldState, dt) -> S.ContactProblem:
        """K2's operands for this frame (the contact set the step would
        solve), for kernel checks against the plain version."""
        c = self._contact_stage(state, dt)
        if c.contacts is None:
            raise ValueError("this frame has no contact stream for K2 (banded branch, or no "
                             "ground and no pairs)")
        return S.prologue(c.pos, c.vel, c.angvel, c.contacts, c.d.inv_mass, c.iiw, c.dt_c,
                          c.fric, c.rest, warm_lambdas=c.warm, **self._solver_kwargs())

    def update_parallel(self, state: WorldState, dt) -> WorldState:
        st = self.statics()
        ms: PhysicsState = state.modules[self.name]
        c = self._contact_stage(state, dt)
        d, pos, rot, vel, angvel = c.d, c.pos, c.rot, c.vel, c.angvel
        batch = pos.shape[:-2]
        zero = torch.zeros(batch, dtype=torch.int32, device=pos.device)
        counters = dict(ms.counters)
        dpos = proj = None
        if st.sap:
            vel, angvel, n_active, miss, proj, carry = self._banded_solve(st, d, c, ms)
            ms = ms.replace(sap_lam=carry[0], sap_glam=carry[1], sap_rank=carry[2])
        elif c.contacts is not None:
            vel, angvel, lams, dpos = S.solve_contacts_fused(
                pos, vel, angvel, c.contacts, d.inv_mass, c.iiw, c.dt_c, c.fric, c.rest,
                iterations=self.solver_iterations, position_iterations=self.position_iterations,
                warm_lambdas=c.warm, **self._solver_kwargs())
            ms = ms.replace(lam_n=lams[0], lam_t1=lams[1], lam_t2=lams[2], pair_key=c.pair_key)
            n_active = torch.sum(c.contacts.active, dim=-1).to(torch.int32)
            miss = c.miss if st.pruned else zero
        else:
            n_active, miss = zero, zero
        if st.pruned:
            counters["pruned_pair_miss"] = miss
        if len(st.joint_a):
            vel, angvel = self._solve_joints(st, d, pos, rot, vel, angvel, c.dt_c)
        pos, rot = P.integrate_positions(pos, rot, vel, angvel, c.dt_c, d.dyn)
        if self.position_iterations > 0:
            if dpos is not None:
                pos = pos + dpos  # dpos depends only on the contact set
            elif proj is not None:
                pos = proj(pos)
        vel, angvel, sleep, _ = P.update_sleep(vel, angvel, ms.sleep, d.dyn)
        counters.update(active_contacts=n_active, sap_window_miss=miss)
        ms = ms.replace(pos=pos, rot=rot, vel=vel, angvel=angvel, sleep=sleep, counters=counters)
        return state.replace(modules={**state.modules, self.name: ms})

    # -- the banded branch ------------------------------------------------------

    def _banded_solve(self, st: PhysStatics, d, c, ms: PhysicsState):
        """The banded contact solve for each world of the batch (the sweeps
        sort one world's bodies). Returns (vel, angvel, n_active, miss,
        projection, warm-start carry)."""
        batch = c.pos.shape[:-2]
        if not batch:
            return self._banded_solve_world(st, d, c.pos, c.rot, c.vel, c.angvel, c.gc,
                                            c.dt_c, ms)
        n = int(np.prod(batch))

        def world(x, i):
            return x.reshape((n,) + x.shape[len(batch):])[i]

        outs = []
        for i in range(n):
            gc = None if c.gc is None else c.gc._replace(
                point=world(c.gc.point, i), normal=world(c.gc.normal, i),
                depth=world(c.gc.depth, i), active=world(c.gc.active, i))
            wms = ms.replace(sap_lam=world(ms.sap_lam, i), sap_glam=world(ms.sap_glam, i),
                             sap_rank=world(ms.sap_rank, i))
            outs.append(self._banded_solve_world(st, d, world(c.pos, i), world(c.rot, i),
                                                 world(c.vel, i), world(c.angvel, i), gc,
                                                 c.dt_c, wms))

        def stack(xs):
            return torch.stack(xs).reshape(batch + xs[0].shape)

        projs = [o[4] for o in outs]

        def proj(p):
            flat = p.reshape((n,) + p.shape[len(batch):])
            return stack([f(flat[i]) for i, f in enumerate(projs)])

        carry = tuple(stack([o[5][j] for o in outs]) for j in range(3))
        return (stack([o[0] for o in outs]), stack([o[1] for o in outs]),
                stack([o[2] for o in outs]), stack([o[3] for o in outs]), proj, carry)

    def _banded_solve_world(self, st: PhysStatics, d, pos, rot, vel, angvel, gc, dt_c,
                            ms: PhysicsState):
        """One world's multi-sweep banded pipeline: one banded grid per sweep
        order (sweep_orders: offset cell columns put every overlapping pair in
        some sweep's window), pairs an earlier sweep already holds masked
        out, solved jointly by solve_contacts_banded_multi in body order. The
        miss count is the per-step window certificate (0: no contact was
        dropped). Last frame's lambdas are re-matched through the previous
        rank maps and seed the solve."""
        K, k, nb = self.sap_neighbors, self.points_per_pair, pos.shape[-1]
        sys = self.system
        occ = d.occ
        mn, mx = P.world_aabb(pos, rot, d.shape, d.radius, d.he)
        far = torch.where(occ, 0.0, 1e9)   # dead slots park far +x, never pair
        mn, mx = mn + far[None, :], mx + far[None, :]
        orders, ranks, col_keys = PBD.sweep_orders(mn, mx, occ, self.sap_sweeps)
        warm_in, sweeps = [], []
        miss = torch.zeros((), dtype=torch.int32, device=pos.device)
        n_active = torch.zeros((), dtype=torch.int32, device=pos.device)
        for s, (order, ck) in enumerate(zip(orders, col_keys)):
            def rk(x, _o=order):
                return x.index_select(-1, _o)

            sp, sr = rk(pos), rk(rot)
            s_dyn, s_occ, s_layer = rk(d.dyn), rk(occ), rk(d.layer)
            s_fric, s_rest = rk(d.friction_body), rk(d.restitution_body)
            s_mn, s_mx = rk(mn), rk(mx)
            p_point, p_normal, p_depth, p_raw, ok = PBD.banded_pair_grids(
                sp, sr, rk(d.radius), rk(d.he), rk(d.shape), s_mn, s_mx, K, k,
                any_caps=st.any_caps)
            layer_ok = d.layer_matrix[s_layer[None, :] * MAX_LAYERS
                                      + PBD.banded_pair_data(s_layer, K)]
            ok = (ok & layer_ok & (s_dyn[None, :] | PBD.banded_pair_data(s_dyn, K))
                  & s_occ[None, :] & PBD.banded_pair_data(s_occ, K))
            if s > 0:
                ok = ok & ~PBD.cross_sweep_coverage(order, ranks[:s], K)
            fric_b, rest_b = PBD.banded_pair_data(s_fric, K), PBD.banded_pair_data(s_rest, K)
            sw = {"order": order, "p_point": p_point, "p_normal": p_normal, "p_depth": p_depth,
                  "p_active": p_raw & ok[None, :, :],
                  "p_fric": torch.sqrt(torch.clamp_min(s_fric[None, :] * fric_b, 0.0))[None]
                  .expand(p_depth.shape),
                  "p_rest": torch.maximum(s_rest[None, :], rest_b)[None].expand(p_depth.shape)}
            wl = PBD.match_warm_lams(ms.sap_lam[s], ms.sap_rank[s], order, K)
            warm_in.append({"p": (wl[0], wl[1], wl[2])})
            if s == 0 and gc is not None:
                gsl = gc.depth.shape[-1] // nb
                sw["g_point"] = rk(gc.point.reshape(3, gsl, nb))
                sw["g_normal"] = rk(gc.normal.reshape(3, gsl, nb))
                sw["g_depth"] = rk(gc.depth.reshape(gsl, nb))
                sw["g_active"] = rk(gc.active.reshape(gsl, nb)) & s_occ[None, :]
                sw["g_fric"] = torch.sqrt(torch.clamp_min(s_fric * sys.ground_friction, 0.0))[
                    None, :].expand(sw["g_depth"].shape)
                sw["g_rest"] = torch.clamp_min(s_rest, sys.ground_restitution)[None, :].expand(
                    sw["g_depth"].shape)
                n_active = n_active + torch.sum(sw["g_active"]).to(torch.int32)
                warm_in[0]["g"] = tuple(rk(ms.sap_glam[j]) for j in range(3))
            if ck is not None:
                miss = miss + PBD.column_window_miss(s_mn, s_mx, rk(ck), K, occ=s_occ)
            elif len(orders) == 1:
                miss = miss + PBD.window_miss(s_mn, s_mx, K, occ=s_occ)
            n_active = n_active + torch.sum(sw["p_active"]).to(torch.int32)
            sweeps.append(sw)

        iiw = P.inv_inertia_world_diag(rot, d.inv_inertia_body)
        vel, angvel, lams = PBD.solve_contacts_banded_multi(
            vel, angvel, d.inv_mass, iiw, pos, sweeps, dt_c, iterations=self.solver_iterations,
            warm=warm_in, **self._solver_kwargs())

        def proj(p):
            return PBD.project_positions_banded_multi(p, sweeps, d.inv_mass,
                                                      iterations=self.position_iterations)

        new_lam = torch.stack([torch.stack(lam[3:6]) for lam in lams])
        new_glam = ms.sap_glam
        if gc is not None:
            new_glam = PBD._unrank(torch.stack(lams[0][0:3]), orders[0])
        carry = (new_lam, new_glam, torch.stack(ranks).to(torch.int32))
        return vel, angvel, n_active, miss, proj, carry

    # -- joints -----------------------------------------------------------------

    def _solve_joints(self, st: PhysStatics, d, pos, rot, vel, angvel, dt):
        """Velocity-level joint constraints with a positional Baumgarte bias,
        4 relaxed Jacobi passes over the joint set: distance along the anchor
        line (exact length or a [min, max] band), the point constraint of the
        spherical, hinge and d6 joints (d6: on its locked frame-A axes only);
        then the hinge's off-axis angular velocity removed, its drive and its
        angle limits, and the d6's locked angular axes."""
        ja, jb = d.joint_a, d.joint_b
        nb = pos.shape[-1]
        im = d.inv_mass
        im_a, im_b = im[ja], im[jb]
        iiw = P.inv_inertia_world_diag(rot, d.inv_inertia_body)
        II_a, II_b = iiw.index_select(-1, ja), iiw.index_select(-1, jb)
        rot_a, rot_b = rot.index_select(-1, ja), rot.index_select(-1, jb)
        r_a = lm.quat_rotate(rot_a, d.joint_anchor_a, axis=AX)
        r_b = lm.quat_rotate(rot_b, d.joint_anchor_b, axis=AX)
        err_vec = (pos.index_select(-1, jb) + r_b) - (pos.index_select(-1, ja) + r_a)

        def ang_term(r, e, II):
            return torch.sum(lm.cross(II * lm.cross(r, e, axis=AX), r, axis=AX) * e, dim=AX)

        def k_along(e):
            return im_a + im_b + ang_term(r_a, e, II_a) + ang_term(r_b, e, II_b)

        basis = [d.eye[:, i, None].expand(err_vec.shape) for i in range(3)]
        k_axes = torch.stack([k_along(e) for e in basis], dim=AX)
        dist = torch.sqrt(torch.clamp_min(torch.sum(err_vec * err_vec, dim=AX), 1e-12))
        n = err_vec / dist[..., None, :]
        has_band = d.joint_has_band
        err_band = (torch.clamp_min(dist - d.joint_max_dist, 0.0)
                    - torch.clamp_min(d.joint_min_dist - dist, 0.0))
        err_d = has_band * err_band + (1.0 - has_band) * (dist - d.joint_len)
        k_n = k_along(n)
        if st.has_d6_config:
            frame_axes = [lm.quat_rotate(rot_a, d.eye[:, i, None], axis=AX) for i in range(3)]
            k_frame = [torch.clamp_min(k_along(e), 1e-9) for e in frame_axes]
        beta, relax = 0.1, 0.6
        for _ in range(4):
            va = vel.index_select(-1, ja) + lm.cross(angvel.index_select(-1, ja), r_a, axis=AX)
            vb = vel.index_select(-1, jb) + lm.cross(angvel.index_select(-1, jb), r_b, axis=AX)
            vrel = vb - va
            vn = torch.sum(vrel * n, dim=AX)
            act_d = has_band * (torch.abs(err_d) > 0).to(torch.float32) + (1.0 - has_band)
            lam_d = -(vn + beta * err_d / dt) / torch.clamp_min(k_n, 1e-9) * relax * act_d
            imp_dist = n * lam_d[..., None, :]
            imp_point = -(vrel + beta * err_vec / dt) / torch.clamp_min(k_axes, 1e-9) * relax
            if st.has_d6_config:
                imp_d6 = torch.zeros_like(imp_point)
                for i, e in enumerate(frame_axes):
                    verr = torch.sum(vrel * e, dim=AX)
                    perr = torch.sum(err_vec * e, dim=AX)
                    lam_e = -(verr + beta * perr / dt) / k_frame[i] * relax
                    imp_d6 = imp_d6 + e * (lam_e * d.joint_lin_mask[i])[..., None, :]
                is_d6 = d.joint_is_d6.to(torch.float32)[..., None, :]
                imp_point = imp_point * (1.0 - is_d6) + imp_d6 * is_d6
            imp = torch.where(d.joint_is_dist[..., None, :], imp_dist, imp_point)
            vel = vel + (_scatter(imp, jb, nb) - _scatter(imp, ja, nb)) * im[None, :]
            angvel = angvel + (_scatter(lm.cross(r_b, imp, axis=AX), jb, nb)
                               - _scatter(lm.cross(r_a, imp, axis=AX), ja, nb)) * iiw

        hinge = np.nonzero(st.joint_type == 2)[0]
        if hinge.size:
            hj = torch.as_tensor(hinge, device=pos.device)
            ha, hb = ja[hj], jb[hj]
            rot_ah, rot_bh = rot_a.index_select(-1, hj), rot_b.index_select(-1, hj)
            axis_l = d.joint_axis.index_select(-1, hj)
            axis_w = lm.quat_rotate(rot_ah, axis_l, axis=AX)
            wrel = angvel.index_select(-1, hb) - angvel.index_select(-1, ha)
            off_axis = wrel - axis_w * torch.sum(wrel * axis_w, dim=AX)[..., None, :]
            imw = iiw.index_select(-1, ha) + iiw.index_select(-1, hb)
            tau = -off_axis / torch.clamp_min(imw, 1e-9)
            k_ax = torch.clamp_min(torch.sum(axis_w * imw * axis_w, dim=AX), 1e-9)
            w_ax = torch.sum(wrel * axis_w, dim=AX)
            # drive toward the target angular velocity, force-limited per step
            fmax = d.joint_drive_force[hj] * dt
            lam_d = torch.minimum(torch.maximum((d.joint_drive_vel[hj] - w_ax) / k_ax, -fmax),
                                  fmax) * d.joint_drive_on[hj]
            # limits: the twist about the axis of the rest-relative rotation
            rel = lm.quat_mul(lm.quat_conjugate(rot_ah, axis=AX), rot_bh, axis=AX)
            dtw = lm.quat_mul(lm.quat_conjugate(d.joint_rest_rel.index_select(-1, hj), axis=AX),
                              rel, axis=AX)
            angle = 2.0 * torch.atan2(torch.sum(dtw[..., 0:3, :] * axis_l, dim=AX), dtw[..., 3, :])
            over = (torch.clamp_min(angle - d.joint_limit_max[hj], 0.0)
                    - torch.clamp_min(d.joint_limit_min[hj] - angle, 0.0))
            lam_l = ((-(0.2 / dt) * over - torch.where(torch.abs(over) > 0, w_ax, 0.0)) / k_ax
                     * d.joint_limit_on[hj])
            t = tau + axis_w * (lam_d + lam_l)[..., None, :]
            angvel = angvel + (_scatter(t, hb, nb) - _scatter(t, ha, nb)) * iiw

        if st.has_d6_config and np.any(st.joint_ang_mask):
            d6 = np.nonzero(st.joint_type == 3)[0]
            if d6.size:
                dj = torch.as_tensor(d6, device=pos.device)
                da, db = ja[dj], jb[dj]
                rot_ad = rot_a.index_select(-1, dj)
                wrel = angvel.index_select(-1, db) - angvel.index_select(-1, da)
                imw = iiw.index_select(-1, da) + iiw.index_select(-1, db)
                amask = d.joint_ang_mask.index_select(-1, dj)
                locked = torch.zeros_like(wrel)
                for i in range(3):
                    e = lm.quat_rotate(rot_ad, d.eye[:, i, None], axis=AX)
                    locked = locked + e * (torch.sum(wrel * e, dim=AX) * amask[i])[..., None, :]
                tau6 = -locked / torch.clamp_min(imw, 1e-9)
                angvel = angvel + (_scatter(tau6, db, nb) - _scatter(tau6, da, nb)) * iiw
        return vel, angvel

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

    def raycast(self, ms: PhysicsState, origin, direction, layer_mask: int = -1):
        raise NotImplementedError("PhysicsModule.raycast (physics_ops.raycast_all) is not ported")

    def sweep(self, ms: PhysicsState, origin, direction, sweep_radius: float,
              layer_mask: int = -1):
        raise NotImplementedError("PhysicsModule.sweep (physics_ops.sweep) is not ported")


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

    def set_layers_collide(self, a: int, b: int, collide: bool) -> None:
        self.layer_matrix[a, b] = collide
        self.layer_matrix[b, a] = collide

    def create_modules(self, world: World) -> PhysicsModule:
        caps = getattr(self.engine, "module_capacities", {})
        return PhysicsModule(world, self, max_actors=caps.get("actors", 256),
                             max_joints=caps.get("joints", 64))
