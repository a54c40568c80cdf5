"""PhysicsModule + PhysicsSystem (counterpart of
``lumixengine_tpu/physics/module.py``): rigid actors with sphere, box,
capsule and convex-hull shapes, dynamic, static or kinematic, the collision
layer matrix, the ground plane or a heightfield terrain, static triangle
meshes baked to SDF grids (``mesh_collider``), instanced static cubes and
hulls (``instanced_cube``, ``instanced_mesh``), the four joint types,
sleeping, CCD, raycast-suspension vehicles with their wheels, capsule
character controllers and the raycast and sphere-sweep queries, under the
three broadphase branches the reference's ``broadphase="auto"`` picks:

* all-pairs (at most ``pruned_threshold`` candidate pairs): the static pair
  lists, every pair in the contact stream each frame;
* pruned (more candidate pairs): the AABB-overlapping simple pairs compacted
  into a fixed budget each frame, their warm-start impulses gated by pair
  identity (pairs with a hull stay in the static stream);
* banded (above ``sap_threshold`` actor slots): the multi-sweep rank-space
  pipeline of ``ops/physics_banded.py``, with its warm-start carry and its
  per-frame window certificate; pairs with a hull take the polytope SAT, and
  the hulls' ground contacts and the SDF streams join the per-body stream.

One frame of ``update_parallel``: clamp dt to 1/20 s, static and kinematic
bodies take their entity's world pose, integrate velocities, the vehicles'
suspension, drive and grip impulses, build the contact streams [ground or
heightfield | simple pairs | convex pairs | convex ground | SDF] (the
pruned branch appends its compacted pairs), solve them (kernel K2 in the
first two branches, the banded Jacobi solve in the third), the joints,
integrate positions, clamp the CCD bodies' motion, add the projection's
dpos, update sleep. ``update`` steps the character controllers and writes
them and the dynamic bodies back to their entities' local transforms.
``broadphase="sap"`` raises NotImplementedError.
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
from lumixengine_tpu_torch.ops import convex_ops as CV
from lumixengine_tpu_torch.ops import physics_banded as PBD
from lumixengine_tpu_torch.ops import physics_ops as P
from lumixengine_tpu_torch.ops import solver as S
from lumixengine_tpu_torch.ops.physics_big import compact_pairs
from lumixengine_tpu_torch.physics.cooking import cook_convex_cached, cook_mesh_sdf_cached
from lumixengine_tpu_torch.utils.store import DenseStore

MOTION_STATIC = 0
MOTION_DYNAMIC = 1
MOTION_KINEMATIC = 2

MAX_LAYERS = 32
AX = -2
JOINT_TYPES = {"distance_joint": 0, "spherical_joint": 1, "hinge_joint": 2, "d6_joint": 3}
CCD_SAMPLES = 4   # points sampled along a CCD body's step


@dataclass
class PhysicsState:
    pos: torch.Tensor       # f32 [3, NB]
    rot: torch.Tensor       # f32 [4, NB]
    vel: torch.Tensor       # f32 [3, NB]
    angvel: torch.Tensor    # f32 [3, NB]
    sleep: torch.Tensor     # int32 [NB] calm-frame counter
    # character controllers [NC]
    ctrl_pos: torch.Tensor       # f32 [3, NC] capsule foot positions
    ctrl_vel_y: torch.Tensor     # f32 [NC] vertical speed under their own gravity
    ctrl_disp: torch.Tensor      # f32 [3, NC] displacement queued by move_controller
    ctrl_grounded: torch.Tensor  # bool [NC]
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
    veh_throttle: torch.Tensor  # f32 [NV] driver inputs: throttle in [-1, 1]
    veh_steer: torch.Tensor     # f32 [NV] steering angle, radians
    counters: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "PhysicsState":
        return dataclasses.replace(self, **kw)


class PhysStatics:
    """Host constants: mass properties, the instanced static slots, the
    polytope and SDF collider data, the branch and its pair lists, the static
    contact-slot layout [ground | pairs | convex pairs | convex ground | SDF]
    with its materials, the joints, the controllers, the vehicles and the
    heightfield."""

    def __init__(self, module: "PhysicsModule"):
        w = module.world
        st = module.actors
        nb = st.capacity
        occupied = st.entity >= 0
        motion = np.asarray(st.data["motion"], np.int32)
        if module.broadphase == "sap":
            raise NotImplementedError(
                "broadphase='sap' (PhysicsModule._sap_solve on physics_big.sap_pairs, "
                "solve_contacts_dynamic, project_positions_dynamic) is not ported")
        self.entity_slots = w.to_slots(st.entity)
        self.shape = np.asarray(st.data["shape"], np.int32)
        self.radius = np.asarray(st.data["radius"], np.float32)
        self.half_extents = np.asarray(st.data["half_extents"], np.float32).T.copy()  # [3,NB]
        self.layer = np.asarray(st.data["layer"], np.int32)
        friction = np.asarray(st.data["friction"], np.float32)
        restitution = np.asarray(st.data["restitution"], np.float32)
        mass = np.asarray(st.data["mass"], np.float32)
        ccd_flags = np.asarray(st.data["ccd"], bool)
        hull_ids = np.asarray(st.data["hull"], np.int32)

        # instanced statics: frozen static slots past the store's capacity,
        # posed once here, never synced from an entity
        inst = module._expand_instanced()
        self.n_instanced = 0 if inst is None else inst["shape"].shape[0]
        if inst is not None:
            n_i = self.n_instanced
            occupied = np.concatenate([occupied, np.ones(n_i, bool)])
            motion = np.concatenate([motion, np.full(n_i, MOTION_STATIC, np.int32)])
            self.entity_slots = np.concatenate(
                [self.entity_slots, w.to_slots(inst["owner"])]).astype(np.int32)
            self.shape = np.concatenate([self.shape, inst["shape"]])
            self.radius = np.concatenate([self.radius, inst["radius"]])
            self.half_extents = np.concatenate([self.half_extents, inst["half_extents"]], axis=1)
            self.layer = np.concatenate([self.layer, inst["layer"]])
            friction = np.concatenate([friction, np.full(n_i, 0.5, np.float32)])
            restitution = np.concatenate([restitution, np.zeros(n_i, np.float32)])
            mass = np.concatenate([mass, np.ones(n_i, np.float32)])
            ccd_flags = np.concatenate([ccd_flags, np.zeros(n_i, bool)])
            hull_ids = np.concatenate([hull_ids, inst["hull"]])
            self.inst_pos, self.inst_rot = inst["pos"], inst["rot"]   # [3, E], [4, E]
            nb += n_i

        self.nb = nb
        self.occupied = occupied
        self.dyn_mask = occupied & (motion == MOTION_DYNAMIC)
        self.ccd_mask = self.dyn_mask & ccd_flags
        self.has_ccd = bool(self.ccd_mask.any())
        # conservative CCD thickness: a sphere's or capsule's radius, else the least extent
        self.ccd_r = np.where(
            self.shape == P.SHAPE_SPHERE, self.radius,
            np.where(self.shape == P.SHAPE_CAPSULE, self.radius,
                     np.abs(self.half_extents).min(axis=0))).astype(np.float32)
        self.kin_mask = occupied & (motion != MOTION_DYNAMIC)
        if self.n_instanced:
            self.kin_mask[-self.n_instanced:] = False
        self.inv_mass = np.where(self.dyn_mask, 1.0 / np.maximum(mass, 1e-6), 0.0).astype(np.float32)
        self.friction_body = friction.copy()
        self.restitution_body = restitution.copy()

        # body-space inverse inertia (diagonal): sphere and capsule 2/5·m·r²,
        # box m/12·(e² + e²), a hull its cooked inertia scaled to its mass
        he = self.half_extents
        self.hull_ids = hull_ids
        is_convex = self.shape == P.SHAPE_CONVEX
        conv_inertia = np.ones((3, nb), np.float32)
        for slot in np.nonzero(occupied & is_convex)[0]:
            h = module.hulls[int(hull_ids[slot])]
            conv_inertia[:, slot] = h.inertia_diag * (mass[slot] / max(h.volume, 1e-9))
        ib = np.zeros((3, nb), np.float32)
        for a in range(3):
            b_, c_ = (a + 1) % 3, (a + 2) % 3
            box_i = mass / 12.0 * ((2 * he[b_]) ** 2 + (2 * he[c_]) ** 2)
            sph_i = 0.4 * mass * self.radius**2
            ii = np.where(self.shape == P.SHAPE_BOX, box_i, np.where(is_convex, conv_inertia[a], sph_i))
            ib[a] = np.where(self.dyn_mask, 1.0 / np.maximum(ii, 1e-9), 0.0)
        self.inv_inertia_body = ib
        self.ground_plane = bool(module.system.ground_plane)
        self.ground_slots = module.ground_slots_per_body
        self.sap = module.sap_active()
        self.any_caps = bool(np.any(occupied & (self.shape == P.SHAPE_CAPSULE)))

        # polytope data (the convex narrowphase, and the SDF candidate points):
        # every shape as padded local vertices and a support radius
        self.is_convex = is_convex
        self.conv_idx = np.nonzero(occupied & is_convex & self.dyn_mask)[0].astype(np.int32)
        self.has_convex = bool(np.any(occupied & is_convex))
        # SDF mesh colliders (grid, origin, cell, pos, rot), posed once here
        self.sdf_colliders = []
        mc = module.mesh_colliders
        for slot in range(mc.capacity):
            e = int(mc.entity[slot])
            if e >= 0:
                sdf = module.sdfs[int(mc.data["sdf"][slot])]
                mpos, mrot, _ = w.get_global_transform(e)
                self.sdf_colliders.append((sdf.grid, sdf.origin, float(sdf.cell),
                                           np.asarray(mpos, np.float32),
                                           np.asarray(mrot, np.float32)))
        self.need_polytopes = self.has_convex or bool(self.sdf_colliders)
        if self.need_polytopes:
            vmax, fmax = 8, 3
            for slot in np.nonzero(occupied & is_convex)[0]:
                h = module.hulls[int(hull_ids[slot])]
                vmax, fmax = max(vmax, h.verts.shape[0]), max(fmax, h.axes.shape[0])
            pv = np.zeros((3, vmax, nb), np.float32)
            pvv = np.zeros((vmax, nb), bool)
            pax = np.zeros((3, fmax, nb), np.float32)
            pax[1, :, :] = 1.0  # padding axis: +y
            prad = np.zeros(nb, np.float32)
            eye3 = np.eye(3, dtype=np.float32)
            for slot in np.nonzero(occupied)[0]:
                sh = int(self.shape[slot])
                if sh == P.SHAPE_BOX:
                    pv[:, :8, slot] = P._CORNER_SIGNS * he[:, slot][:, None]
                    pvv[:8, slot] = True
                    pax[:, :3, slot] = eye3
                elif sh == P.SHAPE_SPHERE:
                    pvv[0, slot] = True
                    prad[slot] = self.radius[slot]
                elif sh == P.SHAPE_CAPSULE:
                    pv[1, 0, slot], pv[1, 1, slot] = he[1, slot], -he[1, slot]
                    pvv[:2, slot] = True
                    prad[slot] = self.radius[slot]
                else:
                    h = module.hulls[int(hull_ids[slot])]
                    kv, kf = h.verts.shape[0], h.axes.shape[0]
                    pv[:, :kv, slot] = h.verts.T
                    pv[:, kv:, slot] = h.verts.T[:, :1]   # padded by vertex 0: support-exact
                    pvv[:h.n_verts, slot] = True
                    pax[:, :kf, slot] = h.axes.T
                    pax[:, kf:, slot] = h.axes.T[:, :1]
            self.poly_verts, self.poly_vert_valid, self.poly_axes, self.poly_rad = pv, pvv, pax, prad
            # support intervals along each face axis (exact convex raycasts)
            dots = np.einsum("cfn,cvn->fvn", pax, pv)
            lo = np.where(pvv[None, :, :], dots, 1e9).min(axis=1) - prad[None, :]
            hi = np.where(pvv[None, :, :], dots, -1e9).max(axis=1) + prad[None, :]
            self.poly_axis_lo, self.poly_axis_hi = lo.astype(np.float32), hi.astype(np.float32)
            self.dyn_idx = np.nonzero(self.dyn_mask)[0].astype(np.int32)
        else:
            self.dyn_idx = np.zeros(0, np.int32)

        # heightfield: the first one wins; its heights come from the renderer's terrains
        self.heightfield_terrain = -1
        self.heightfield_origin = (0.0, 0.0, 0.0)
        hf = module.heightfields
        for slot in range(hf.capacity):
            e = int(hf.entity[slot])
            if e >= 0:
                self.heightfield_terrain = int(hf.data["terrain"][slot])
                self.heightfield_origin = tuple(float(x) for x in w.get_global_transform(e)[0])
                break
        # hulls take the polytope ground stream against the plane (and leave
        # the generic ground or heightfield stream)
        self.has_conv_gnd = self.has_convex and self.ground_plane

        ppp = module.points_per_pair
        self.pruned = False
        if self.sap:
            self.pair_a = self.pair_b = np.zeros(0, np.int32)
            self.conv_pair_a = self.conv_pair_b = np.zeros(0, np.int32)
        else:
            # static candidate pairs: occupied, one dynamic, layer matrix
            # allows; pairs with a hull take the polytope narrowphase
            lm_ = module.system.layer_matrix
            ii, jj = np.triu_indices(nb, k=1)
            keep = occupied[ii] & occupied[jj]
            keep &= (motion[ii] == MOTION_DYNAMIC) | (motion[jj] == MOTION_DYNAMIC)
            keep &= lm_[self.layer[ii], self.layer[jj]]
            cvx = is_convex[ii] | is_convex[jj]
            self.pair_a = ii[keep & ~cvx].astype(np.int32)
            self.pair_b = jj[keep & ~cvx].astype(np.int32)
            self.conv_pair_a = ii[keep & cvx].astype(np.int32)
            self.conv_pair_b = jj[keep & cvx].astype(np.int32)
            self.pruned = module.broadphase == "pruned" or (
                module.broadphase == "auto" and len(self.pair_a) > module.pruned_threshold)
            if self.pruned:
                budget = module.pair_budget or max(128, 6 * int(np.sum(self.dyn_mask)))
                self.pair_budget = int(min(budget, len(self.pair_a)))
            # static contact slots [ground | simple pairs | convex pairs |
            # convex ground | SDF]; in the pruned branch the simple pairs are
            # compacted at run time and appended last instead
            gnd = (module.ground_slots_per_body
                   if (self.ground_plane or self.heightfield_terrain >= 0) else 0)
            parts_a = [np.tile(np.arange(nb, dtype=np.int32), gnd)]
            parts_b = [np.full(gnd * nb, -1, np.int32)]
            if not self.pruned:
                parts_a.append(np.tile(self.pair_a, ppp))
                parts_b.append(np.tile(self.pair_b, ppp))
            parts_a.append(np.tile(self.conv_pair_a, ppp))
            parts_b.append(np.tile(self.conv_pair_b, ppp))
            if self.has_conv_gnd:
                kg = module.ground_slots_per_body
                parts_a.append(np.tile(self.conv_idx, kg))
                parts_b.append(np.full(len(self.conv_idx) * kg, -1, np.int32))
            for _ in self.sdf_colliders:
                v_slots = self.poly_verts.shape[1]
                parts_a.append(np.tile(self.dyn_idx, v_slots))
                parts_b.append(np.full(len(self.dyn_idx) * v_slots, -1, np.int32))
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

        # character controllers
        c = module.controllers
        self.ctrl_mask = c.entity >= 0
        self.ctrl_entity_slots = w.to_slots(c.entity)
        self.ctrl_gravity = np.asarray(c.data["gravity"], np.float32)

        # vehicles and wheels: the raycast-suspension parameters per wheel
        v = module.vehicles
        self.veh_torque = np.asarray(v.data["peak_torque"], np.float32)
        veh_body = np.asarray(v.data["body"], np.int32)
        wh = module.wheels
        wveh = np.full(wh.capacity, -1, np.int32)
        for i in np.nonzero(wh.entity >= 0)[0]:
            wveh[i] = module.vehicles.slot_of(int(wh.data["vehicle_ent"][i]))
        self.wheel_mask = (wh.entity >= 0) & (wveh >= 0)
        self.wheel_vehicle = np.maximum(wveh, 0)
        self.wheel_body = np.where(self.wheel_mask, veh_body[self.wheel_vehicle], 0).astype(np.int32)
        self.wheel_radius = np.asarray(wh.data["radius"], np.float32)
        self.wheel_droop = np.asarray(wh.data["max_droop"], np.float32)
        self.wheel_comp = np.asarray(wh.data["max_compression"], np.float32)
        self.wheel_spring = np.asarray(wh.data["spring_strength"], np.float32)
        self.wheel_damper = np.asarray(wh.data["spring_damper_rate"], np.float32)
        self.wheel_slot = np.asarray(wh.data["slot"], np.int32)
        self.wheel_anchor = np.asarray(wh.data["anchor"], np.float32).T.copy()  # [3,NW]
        self.has_vehicles = bool(self.wheel_mask.any())
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
                is_convex=t(self.is_convex),
                gc_dyn=t(self.dyn_mask & ~self.is_convex if self.has_conv_gnd else self.dyn_mask),
                layer_masks={},
            )
            if self.heightfield_terrain >= 0:
                d.slot_mask = t(P.candidate_slot_mask(self.shape, self.ground_slots))
            if self.need_polytopes:
                d.poly_verts, d.poly_axes = t(self.poly_verts), t(self.poly_axes)
                d.poly_rad = t(self.poly_rad)
                d.poly_axis_lo, d.poly_axis_hi = t(self.poly_axis_lo), t(self.poly_axis_hi)
                d.conv_idx = t(self.conv_idx, i64)
                d.conv_verts = t(self.poly_verts[:, :, self.conv_idx])
                d.conv_rad = t(self.poly_rad[self.conv_idx])
                d.conv_pair_a, d.conv_pair_b = t(self.conv_pair_a, i64), t(self.conv_pair_b, i64)
                d.conv_dyn = t(self.dyn_mask & self.is_convex)
                # SDF candidate points: the dynamic bodies' polytope vertices
                # (every slot in the banded branch, whose streams are per body)
                sel = np.arange(self.nb, dtype=np.int32) if self.sap else self.dyn_idx
                v_slots = self.poly_verts.shape[1]
                d.sdf_sel = t(sel, i64)
                d.sdf_verts = t(self.poly_verts[:, :, sel])
                d.sdf_eff_r = t(np.tile(self.poly_rad[sel], v_slots))
                d.sdf_body = t(np.tile(sel, v_slots), i64)
                d.sdf_valid = t((self.poly_vert_valid[:, sel] & self.dyn_mask[None, sel]).reshape(-1))
                d.sdf_colliders = [(t(g), t(o), cell, t(mp), t(mr))
                                   for g, o, cell, mp, mr in self.sdf_colliders]
            if self.has_ccd:
                ci = np.nonzero(self.ccd_mask)[0]
                d.ccd_mask, d.ccd_r, d.ccd_idx = t(self.ccd_mask), t(self.ccd_r), t(ci, i64)
                d.ccd_ts = t((np.arange(1, CCD_SAMPLES + 1, dtype=np.float32)
                              / CCD_SAMPLES)[:, None])
                d.ccd_pair_ok = t(self.occupied[None, :] & (ci[:, None] != np.arange(self.nb)[None, :]))
            if self.ctrl_mask.any():
                act = np.nonzero(self.ctrl_mask)[0]
                d.ctrl_mask, d.ctrl_gravity = t(self.ctrl_mask), t(self.ctrl_gravity)
                d.ctrl_cols, d.ctrl_slots = t(act, i64), t(self.ctrl_entity_slots[act], i64)
            if self.has_vehicles:
                d.wheel_mask = t(self.wheel_mask.astype(np.float32))
                d.wheel_body, d.wheel_vehicle = t(self.wheel_body, i64), t(self.wheel_vehicle, i64)
                d.wheel_radius, d.wheel_droop = t(self.wheel_radius), t(self.wheel_droop)
                d.wheel_comp, d.wheel_anchor = t(self.wheel_comp), t(self.wheel_anchor)
                d.wheel_spring, d.wheel_damper = t(self.wheel_spring), t(self.wheel_damper)
                d.wheel_front = t((self.wheel_slot < 2).astype(np.float32))
                d.veh_torque = t(self.veh_torque)
                d.e_y = t(np.array([[0.0], [1.0], [0.0]], np.float32))
                d.e_z = t(np.array([[0.0], [0.0], [1.0]], np.float32))
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
            "hull": ((), np.int32, -1),     # index into self.hulls (convex)
            "ccd": ((), np.bool_, False),   # swept clamp of fast movers (_ccd_clamp)
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
        # capsule character controllers with their own gravity
        self.controllers = DenseStore(32, {"radius": ((), np.float32, 0.4),
                                           "height": ((), np.float32, 1.8),
                                           "gravity": ((), np.float32, -9.81)})
        # heightfield terrain collision (a terrain id of the renderer's terrains)
        self.heightfields = DenseStore(4, {"terrain": ((), np.int32, -1)})
        # cooked convex hulls (physics/cooking.py); actors name theirs by index
        self.hulls: list = []
        # static triangle meshes as baked SDF grids
        self.mesh_colliders = DenseStore(4, {"sdf": ((), np.int32, -1)})
        self.sdfs: list = []
        # raycast-suspension vehicles: a dynamic box chassis, wheels as children
        self.vehicles = DenseStore(8, {
            "mass": ((), np.float32, 1500.0),
            "center_of_mass": ((3,), np.float32, 0.0),
            "moi_multiplier": ((), np.float32, 1.0),
            "chassis_layer": ((), np.int32, 0),
            "wheels_layer": ((), np.int32, 0),
            "peak_torque": ((), np.float32, 500.0),
            "max_rpm": ((), np.float32, 6000.0),
            "body": ((), np.int32, -1)})     # the chassis's actor slot
        self.wheels = DenseStore(32, {
            "vehicle_ent": ((), np.int32, -1),
            "radius": ((), np.float32, 0.35),
            "width": ((), np.float32, 0.2),
            "mass": ((), np.float32, 20.0),
            "moi": ((), np.float32, 1.0),
            "max_droop": ((), np.float32, 0.15),
            "max_compression": ((), np.float32, 0.15),
            "spring_strength": ((), np.float32, 30000.0),
            "spring_damper_rate": ((), np.float32, 4000.0),
            "slot": ((), np.int32, 0),       # 0 front left, 1 front right, 2 rear left, 3 rear right
            "anchor": ((3,), np.float32, 0.0)})  # chassis-local attach point
        # instanced static collision: one frozen static actor per instance of
        # the entity's render instanced_model, made when the statics are built
        self.instanced_cubes: Dict[int, dict] = {}
        self.instanced_meshes: Dict[int, dict] = {}
        self._inst_hull_cache: Dict[tuple, int] = {}
        self.points_per_pair = points_per_pair
        self.ground_slots_per_body = ground_slots_per_body
        self.solver_iterations = solver_iterations
        self.position_iterations = position_iterations
        self._statics: Optional[PhysStatics] = None
        self._statics_version = -1

    def component_types(self):
        return ["rigid_actor", *JOINT_TYPES, "physics_controller", "heightfield", "vehicle",
                "wheel", "mesh_collider", "instanced_cube", "instanced_mesh"]

    def register_hull(self, cooked) -> int:
        """Register a CookedHull (physics/cooking.py) → hull id."""
        self.hulls.append(cooked)
        return len(self.hulls) - 1

    def register_mesh_sdf(self, cooked) -> int:
        """Register a CookedMeshSDF → sdf id."""
        self.sdfs.append(cooked)
        return len(self.sdfs) - 1

    def create_component(self, entity: int, ctype: str, **props):
        if ctype in JOINT_TYPES:
            return self._create_joint(entity, JOINT_TYPES[ctype], props)
        self.invalidate_statics()
        if ctype == "rigid_actor":
            self._create_actor(entity, props)
        elif ctype == "physics_controller":
            self.controllers.add(entity, radius=np.float32(props.get("radius", 0.4)),
                                 height=np.float32(props.get("height", 1.8)),
                                 gravity=np.float32(props.get("gravity", -9.81)))
        elif ctype == "heightfield":
            self.heightfields.add(entity, terrain=np.int32(props.get("terrain", 0)))
        elif ctype == "mesh_collider":
            # a static triangle mesh posed by its entity: a cooked SDF, a
            # registered id, or vertices and triangles to cook
            sdf = props.get("sdf")
            if sdf is None:
                sdf = cook_mesh_sdf_cached(props["vertices"], props["triangles"],
                                           resolution=int(props.get("resolution", 32)))
            sdf_id = sdf if isinstance(sdf, int) else self.register_mesh_sdf(sdf)
            self.mesh_colliders.add(entity, sdf=np.int32(sdf_id))
        elif ctype == "vehicle":
            # the chassis is a dynamic box actor on the same entity, made here if absent
            if self.actors.slot_of(entity) < 0:
                self._create_actor(entity, dict(
                    motion="dynamic", shape="box",
                    half_extents=props.get("chassis_half_extents", (1.0, 0.5, 2.0)),
                    mass=props.get("mass", 1500.0), layer=props.get("chassis_layer", 0)))
            self.vehicles.add(
                entity, mass=np.float32(props.get("mass", 1500.0)),
                center_of_mass=np.asarray(props.get("center_of_mass", (0.0,) * 3), np.float32),
                moi_multiplier=np.float32(props.get("moi_multiplier", 1.0)),
                chassis_layer=np.int32(props.get("chassis_layer", 0)),
                wheels_layer=np.int32(props.get("wheels_layer", 0)),
                peak_torque=np.float32(props.get("peak_torque", 500.0)),
                max_rpm=np.float32(props.get("max_rpm", 6000.0)),
                body=np.int32(self.actors.slot_of(entity)))
        elif ctype == "wheel":
            # a child of its vehicle's entity; the anchor is its local position
            veh = int(props.get("vehicle", self.world.get_parent(entity)))
            self.wheels.add(
                entity, vehicle_ent=np.int32(veh),
                radius=np.float32(props.get("radius", 0.35)),
                width=np.float32(props.get("width", 0.2)),
                mass=np.float32(props.get("mass", 20.0)),
                moi=np.float32(props.get("moi", 1.0)),
                max_droop=np.float32(props.get("max_droop", 0.15)),
                max_compression=np.float32(props.get("max_compression", 0.15)),
                spring_strength=np.float32(props.get("spring_strength", 30000.0)),
                spring_damper_rate=np.float32(props.get("spring_damper_rate", 4000.0)),
                slot=np.int32(props.get("slot", 0)),
                anchor=np.asarray(self.world.local_pos[entity], np.float32))
        elif ctype == "instanced_cube":
            # one static box per instance, its half-extents times the instance's scale
            self.instanced_cubes[entity] = {
                "half_extents": np.asarray(props.get("half_extents", (0.5, 0.5, 0.5)), np.float32),
                "layer": int(props.get("layer", 0))}
        elif ctype == "instanced_mesh":
            # one static hull per instance, cooked from the vertices of the
            # model `mesh` names (empty: the instanced model's own)
            self.instanced_meshes[entity] = {"mesh": props.get("mesh", ""),
                                             "layer": int(props.get("layer", 0))}
        else:
            raise KeyError(ctype)

    def _create_actor(self, entity: int, props):
        motion = props.get("motion", "static")
        motion = {"static": MOTION_STATIC, "dynamic": MOTION_DYNAMIC,
                  "kinematic": MOTION_KINEMATIC}.get(motion, motion)
        shape = props.get("shape", "sphere")
        shape = {"sphere": P.SHAPE_SPHERE, "box": P.SHAPE_BOX, "capsule": P.SHAPE_CAPSULE,
                 "convex": P.SHAPE_CONVEX}.get(shape, shape)
        radius = float(props.get("radius", 0.5))
        he = np.asarray(props.get("half_extents", (0.5, 0.5, 0.5)), np.float32)
        hull_id = -1
        if shape == P.SHAPE_CONVEX:
            # a cooked hull, a registered hull id, or raw points to cook
            hull = props.get("hull")
            if hull is None:
                hull = cook_convex_cached(props["points"])
            if isinstance(hull, int):
                hull_id, hull = hull, self.hulls[hull]
            else:
                hull_id = self.register_hull(hull)
            # bounds for the broadphase AABBs
            radius = hull.bound_radius
            he = np.abs(hull.verts).max(axis=0).astype(np.float32)
        self.actors.add(
            entity,
            motion=np.int32(motion),
            shape=np.int32(shape),
            radius=np.float32(radius),
            half_extents=he,
            mass=np.float32(props.get("mass", 1.0)),
            friction=np.float32(props.get("friction", 0.5)),
            restitution=np.float32(props.get("restitution", 0.0)),
            layer=np.int32(props.get("layer", 0)),
            hull=np.int32(hull_id),
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

    def _expand_instanced(self):
        """The instanced statics: for each instanced_cube or instanced_mesh
        whose entity carries a render instanced_model, one frozen static
        actor per instance, at the owner's translation plus the instance
        offset, rotated by owner·instance, sized by the instance's scale.
        Returns None or the column-stacked arrays PhysStatics appends."""
        rmod = self.world.modules.get("renderer")
        if rmod is None or not (self.instanced_cubes or self.instanced_meshes):
            return None
        rows = []   # (pos3, rot4, shape, radius, he3, layer, hull id, owner)

        def instances_of(e):
            im = rmod.instanced_models.get(e)
            if im is None or not len(im["pos"]):
                return None
            opos, orot, _ = self.world.get_global_transform(e)
            return im, np.asarray(opos, np.float32), np.asarray(orot, np.float32)

        for e, rec in self.instanced_cubes.items():
            got = instances_of(e)
            if got is None:
                continue
            im, opos, orot = got
            for i in range(len(im["pos"])):
                he = rec["half_extents"] * im["scale"][i]
                rows.append((opos + im["pos"][i], hm.quat_mul(orot, im["rot"][i]), P.SHAPE_BOX,
                             float(np.linalg.norm(he)), he, rec["layer"], -1, e))
        for e, rec in self.instanced_meshes.items():
            got = instances_of(e)
            if got is None:
                continue
            im, opos, orot = got
            # `mesh` names a registered model; a name that is none falls back
            # to the instanced model's own geometry
            mid = int(im["model"])
            if rec["mesh"]:
                try:
                    mid = rmod.system.models.get_id(rec["mesh"])
                except KeyError:
                    pass
            pts = rmod.system.models.get(mid).vertex_positions
            if pts is None or not len(pts):
                continue
            for i in range(len(im["pos"])):
                s = np.asarray(im["scale"][i], np.float32)
                key = (mid, tuple(np.round(s, 6).tolist()))
                hid = self._inst_hull_cache.get(key)
                if hid is None:
                    hid = self.register_hull(cook_convex_cached(np.asarray(pts, np.float32) * s))
                    self._inst_hull_cache[key] = hid
                hull = self.hulls[hid]
                rows.append((opos + im["pos"][i], hm.quat_mul(orot, im["rot"][i]), P.SHAPE_CONVEX,
                             float(hull.bound_radius),
                             np.abs(hull.verts).max(axis=0).astype(np.float32), rec["layer"],
                             hid, e))
        if not rows:
            return None
        return {
            "pos": np.stack([r[0] for r in rows], axis=1).astype(np.float32),
            "rot": np.stack([r[1] for r in rows], axis=1).astype(np.float32),
            "shape": np.asarray([r[2] for r in rows], np.int32),
            "radius": np.asarray([r[3] for r in rows], np.float32),
            "half_extents": np.stack([r[4] for r in rows], axis=1).astype(np.float32),
            "layer": np.asarray([r[5] for r in rows], np.int32),
            "hull": np.asarray([r[6] for r in rows], np.int32),
            "owner": np.asarray([r[7] for r in rows], np.int32),
        }

    def sap_active(self) -> bool:
        """True for the large-world branch (no static pair list)."""
        if self.broadphase == "auto":
            return self.actors.capacity > self.sap_threshold
        return self.broadphase in ("sap", "banded")

    def _banded_ground_slots(self, st: PhysStatics) -> int:
        """Slots per body of the banded branch's per-body stream: the ground
        or heightfield stream, the hulls' ground grids and one vertex stream
        per SDF collider (the warm-start carry's G)."""
        g = self.ground_slots_per_body if (st.heightfield_terrain >= 0 or st.ground_plane) else 0
        v = st.poly_verts.shape[1] if st.need_polytopes else 0
        return g + (v if st.has_conv_gnd else 0) + len(st.sdf_colliders) * v

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
        st = self.statics()
        st.on(device, self.system)
        if st.heightfield_terrain >= 0:
            self._terrain_bank(device)

    def _terrain_bank(self, device):
        return self.world.modules["renderer"].system.terrains.bank(device)

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
        if st.n_instanced:
            pos[:, -st.n_instanced:] = st.inst_pos
            rot[:, -st.n_instanced:] = st.inst_rot
        nc = self.controllers.capacity
        cpos = np.zeros((3, nc), np.float32)
        for slot in range(nc):
            e = int(self.controllers.entity[slot])
            if e >= 0:
                cpos[:, slot] = self.world.get_global_transform(e)[0]
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        n_lam = 0 if st.sap else st.n_contact_slots
        if st.sap:
            n_s, k, K = self._sweep_count(), self.points_per_pair, self.sap_neighbors
            sap_lam = torch.zeros((n_s, 3, k, K, nb), **f32)
            sap_glam = torch.zeros((3, self._banded_ground_slots(st), nb), **f32)
            sap_rank = torch.full((n_s, nb), -1, **i32)
        else:
            sap_lam, sap_glam, sap_rank = torch.zeros(0, **f32), torch.zeros(0, **f32), \
                torch.zeros(0, **i32)
        zero = torch.zeros((), **i32)
        nv = self.vehicles.capacity
        return PhysicsState(
            pos=torch.as_tensor(pos, device=device), rot=torch.as_tensor(rot, device=device),
            vel=torch.zeros((3, nb), **f32), angvel=torch.zeros((3, nb), **f32),
            sleep=torch.zeros(nb, **i32),
            ctrl_pos=torch.as_tensor(cpos, device=device), ctrl_vel_y=torch.zeros(nc, **f32),
            ctrl_disp=torch.zeros((3, nc), **f32),
            ctrl_grounded=torch.zeros(nc, dtype=torch.bool, device=device),
            lam_n=torch.zeros(n_lam, **f32), lam_t1=torch.zeros(n_lam, **f32),
            lam_t2=torch.zeros(n_lam, **f32),
            pair_key=torch.full((st.pair_budget if st.pruned else 0,), -1, **i32),
            sap_lam=sap_lam, sap_glam=sap_glam, sap_rank=sap_rank,
            veh_throttle=torch.zeros(nv, **f32), veh_steer=torch.zeros(nv, **f32),
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

    def _ground_stream(self, st: PhysStatics, d, pos, rot):
        """The per-body ground stream: the heightfield's where there is one,
        else the plane's, else None. Hulls leave it when they have their
        polytope ground stream."""
        sys = self.system
        if st.heightfield_terrain >= 0:
            return P.heightfield_contacts(
                pos, rot, d.shape, d.radius, d.he, d.gc_dyn, self._terrain_bank(pos.device),
                st.heightfield_terrain, st.heightfield_origin, d.slot_mask,
                slots_per_body=self.ground_slots_per_body, any_caps=st.any_caps)
        if st.ground_plane:
            return P.ground_contacts(pos, rot, d.shape, d.radius, d.he, d.gc_dyn,
                                     ground_y=sys.ground_y,
                                     slots_per_body=self.ground_slots_per_body,
                                     any_caps=st.any_caps)
        return None

    def _sdf_streams(self, st: PhysStatics, d, pos, rot):
        """One stream per SDF mesh collider: every polytope vertex of the
        dynamic bodies (of every slot in the banded branch) as a candidate
        point with its support radius."""
        if not st.sdf_colliders:
            return []
        vw = CV.polytope_world_verts(pos.index_select(-1, d.sdf_sel), rot.index_select(-1, d.sdf_sel),
                                     d.sdf_verts)                    # [..,3,V,Nd]
        pts = vw.reshape(vw.shape[:-2] + (-1,))
        out = []
        for grid, origin, cell, mpos, mrot in d.sdf_colliders:
            sc = CV.sdf_contacts(pts, d.sdf_eff_r, d.sdf_body, grid, origin, cell, mpos, mrot)
            out.append(sc._replace(active=sc.active & d.sdf_valid))
        return out

    def _contact_stage(self, state: WorldState, dt):
        """Everything before the contact solve: the clamped dt, the poses,
        integrated velocities with the vehicles' impulses, and the contact
        set (None when there is no stream) with its materials, the world
        inverse inertia and the warm-start impulses; in the banded branch
        the per-body stream `gc` instead."""
        st = self.statics()
        sys = self.system
        ms: PhysicsState = state.modules[self.name]
        d = st.on(ms.pos.device, sys)
        dt_c = torch.clamp_max(torch.as_tensor(dt, dtype=torch.float32, device=ms.pos.device),
                               1.0 / 20.0)
        pos, rot = self._poses(state, d)
        vel, angvel = P.integrate_velocities(ms.vel, ms.angvel, dt_c, d.gravity,
                                             sys.linear_damping, sys.angular_damping, d.dyn)
        if st.has_vehicles:
            vel, angvel = self._update_vehicles(d, ms, pos, rot, vel, angvel, dt_c)
        gc = self._ground_stream(st, d, pos, rot)
        sdf_streams = self._sdf_streams(st, d, pos, rot)
        c = SimpleNamespace(dt_c=dt_c, pos=pos, rot=rot, vel=vel, angvel=angvel, gc=gc, d=d,
                            contacts=None, miss=None, pair_key=ms.pair_key)
        if st.sap:
            # every per-body stream joins gc, which the sweeps re-rank whole
            if st.has_conv_gnd:
                cg = CV.polytope_ground_grids(pos, rot, d.poly_verts, d.poly_rad, d.conv_dyn,
                                              sys.ground_y)
                gc = cg if gc is None else P.concat_contacts(gc, cg)
            for sc in sdf_streams:
                gc = sc if gc is None else P.concat_contacts(gc, sc)
            c.gc = gc
            return c
        # streams in the order of the static slot layout
        streams = [] if gc is None else [gc]
        if len(st.pair_a) and not st.pruned:
            streams.append(P.pair_contacts(pos, rot, d.shape, d.radius, d.he, d.pair_a, d.pair_b,
                                           points_per_pair=self.points_per_pair,
                                           any_caps=st.any_caps))
        if len(st.conv_pair_a):
            streams.append(CV.polytope_pair_contacts(pos, rot, d.poly_verts, d.poly_axes, d.poly_rad,
                                                     d.conv_pair_a, d.conv_pair_b,
                                                     points_per_pair=self.points_per_pair))
        if st.has_conv_gnd and len(st.conv_idx):
            streams.append(CV.polytope_ground_contacts(pos, rot, d.conv_verts, d.conv_rad,
                                                       d.conv_idx, sys.ground_y,
                                                       points_per_body=self.ground_slots_per_body))
        streams.extend(sdf_streams)
        contacts = None
        for s in streams:
            contacts = s if contacts is None else P.concat_contacts(contacts, s)
        batch = pos.shape[:-2]
        warm = (ms.lam_n, ms.lam_t1, ms.lam_t2)
        if st.pruned:
            cc, cfric, crest, c.miss, c.pair_key = self._compacted_pair_stream(st, d, pos, rot)
            if contacts is not None:
                contacts = P.concat_contacts(contacts, cc)
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
            if contacts is None:
                return c
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
        pre_pos = pos
        pos, rot = P.integrate_positions(pos, rot, vel, angvel, c.dt_c, d.dyn)
        if st.has_ccd:
            pos = self._ccd_clamp(st, d, pre_pos, pos)
        if self.position_iterations > 0:
            if dpos is not None:
                pos = pos + dpos  # dpos depends only on the contact set
            elif proj is not None:
                pos = proj(pos)
        vel, angvel, sleep, _ = P.update_sleep(vel, angvel, ms.sleep, d.dyn)
        counters.update(active_contacts=n_active, sap_window_miss=miss)
        ms = ms.replace(pos=pos, rot=rot, vel=vel, angvel=angvel, sleep=sleep, counters=counters)
        return state.replace(modules={**state.modules, self.name: ms})

    def _ccd_clamp(self, st: PhysStatics, d, pre_pos, new_pos):
        """Continuous collision for the CCD bodies: CCD_SAMPLES points along
        this step's motion; a fast mover stops at the last sample before the
        first one that penetrates the ground plane, an SDF collider or any
        other body's path sampled at the same times (two fast bodies meeting
        head-on stop before they cross). The discrete solve takes the
        contact the next frame."""
        K = CCD_SAMPLES
        sys = self.system
        nb = new_pos.shape[-1]
        delta = new_pos - pre_pos
        path = pre_pos.unsqueeze(-2) + delta.unsqueeze(-2) * d.ccd_ts    # [..,3,K,NB]
        r_eff = d.ccd_r
        dist = torch.full(path.shape[:-3] + path.shape[-2:], 1e9, device=path.device)  # [..,K,NB]
        if st.ground_plane:
            dist = torch.minimum(dist, path[..., 1, :, :] - sys.ground_y - r_eff)
        if st.sdf_colliders:
            flat = path.reshape(path.shape[:-2] + (K * nb,))
            for grid, origin, cell, mpos, mrot in d.sdf_colliders:
                inv = lm.quat_conjugate(mrot, axis=-1).unsqueeze(-1)
                local = lm.quat_rotate(inv, flat - mpos.unsqueeze(-1), axis=-2)
                dd = CV.sdf_sample(grid, origin, cell, local)
                dist = torch.minimum(dist, dd.reshape(dd.shape[:-1] + (K, nb)) - r_eff)
        # the CCD bodies against every occupied body's sampled path: the
        # relative motion within the step
        ci = d.ccd_idx
        path_i = path.index_select(-1, ci)                                  # [..,3,K,C]
        d_ij = path_i.unsqueeze(-1) - path.unsqueeze(-2)                    # [..,3,K,C,NB]
        dist_ij = torch.sqrt(torch.clamp_min(torch.sum(d_ij * d_ij, dim=-4), 1e-12))
        rad_ij = r_eff[ci][:, None] + r_eff[None, :]                        # [C,NB]
        pair_d = torch.where(d.ccd_pair_ok, dist_ij - rad_ij, 1e9)
        dist = dist.index_copy(-1, ci, torch.minimum(dist.index_select(-1, ci),
                                                     torch.amin(pair_d, dim=-1)))
        hit = dist < 0.0                                                    # [..,K,NB]
        any_hit = torch.any(hit, dim=-2)
        first = torch.argmax(hit.to(torch.int32), dim=-2)                   # first hit sample
        # only fast movers (a step beyond half their thickness): resting CCD
        # bodies sit in contact and must not freeze
        fast = torch.sum(delta * delta, dim=-2) > (0.5 * r_eff) ** 2
        t_safe = torch.where(any_hit & fast & d.ccd_mask, first.to(torch.float32) / K, 1.0)
        return pre_pos + delta * t_safe.unsqueeze(-2)

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
            if st.has_convex:
                # pairs with a hull take the polytope SAT instead
                c_pt, c_n, c_d, c_act = PBD.banded_polytope_grids(
                    sp, sr, rk(d.poly_verts), rk(d.poly_axes), rk(d.poly_rad), K, k)
                s_cvx = rk(d.is_convex)
                cvx_pair = s_cvx[None, :] | PBD.banded_pair_data(s_cvx, K)   # [K, NB]
                p_point = torch.where(cvx_pair, c_pt, p_point)
                p_normal = torch.where(cvx_pair, c_n, p_normal)
                p_depth = torch.where(cvx_pair, c_d, p_depth)
                p_raw = torch.where(cvx_pair, c_act, p_raw)
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

    # -- vehicles and character controllers -------------------------------------

    def set_vehicle_input(self, state: WorldState, entity: int, throttle=0.0,
                          steer=0.0) -> WorldState:
        """Driver inputs of a vehicle: throttle in [-1, 1] and the steering
        angle in radians, each a number or a tensor over the world batch."""
        slot = self.vehicles.slot_of(entity)
        ms: PhysicsState = state.modules[self.name]
        th, sr = ms.veh_throttle.clone(), ms.veh_steer.clone()
        th[..., slot] = torch.as_tensor(throttle, dtype=torch.float32, device=th.device)
        sr[..., slot] = torch.as_tensor(steer, dtype=torch.float32, device=sr.device)
        return state.replace(modules={**state.modules,
                                      self.name: ms.replace(veh_throttle=th, veh_steer=sr)})

    def _update_vehicles(self, d, ms: PhysicsState, pos, rot, vel, angvel, dt):
        """Raycast-suspension vehicle impulses, all wheels at once:
        suspension, a ray from each wheel's anchor along the chassis's down
        axis to the ground plane, spring·compression − damper·(up speed at
        the contact); drive, throttle·peak_torque / wheel radius along the
        chassis's forward axis (steered on the front slots), on grounded
        wheels; lateral grip cancelling the sideways speed, bounded by the
        friction cone of the spring force. The impulses sum into the
        chassis bodies."""
        nb = pos.shape[-1]
        wm, bidx, vidx = d.wheel_mask, d.wheel_body, d.wheel_vehicle
        q = rot.index_select(-1, bidx)                    # [..,4,NW]
        p = pos.index_select(-1, bidx)
        r = lm.quat_rotate(q, d.wheel_anchor, axis=AX)    # lever arm from the chassis's centre
        wpos = p + r
        axes_shape = q[..., :3, :].shape
        up = lm.quat_rotate(q, d.e_y.expand(axes_shape), axis=AX)
        fwd = lm.quat_rotate(q, d.e_z.expand(axes_shape), axis=AX)
        # the ray o + t·(−up) meets y = ground_y at t = (o_y − ground_y) / up_y
        t = (wpos[..., 1, :] - self.system.ground_y) / torch.clamp_min(up[..., 1, :], 1e-3)
        radius = d.wheel_radius
        rest = radius + d.wheel_droop
        compression = torch.minimum(torch.clamp_min(rest - t, 0.0), d.wheel_droop + d.wheel_comp)
        # a buried wheel (t < 0) is fully compressed, not airborne
        grounded = (t <= rest).to(torch.float32) * wm
        cvel = vel.index_select(-1, bidx) + lm.cross(angvel.index_select(-1, bidx), r, axis=AX)
        v_up = torch.sum(cvel * up, dim=AX)
        f_spring = torch.clamp_min(d.wheel_spring * compression - d.wheel_damper * v_up,
                                   0.0) * grounded
        steer = ms.veh_steer.index_select(-1, vidx) * d.wheel_front
        cs, sn = torch.cos(steer), torch.sin(steer)
        side = lm.cross(up, fwd, axis=AX)
        dirv = fwd * cs.unsqueeze(AX) + side * sn.unsqueeze(AX)
        side_s = lm.cross(up, dirv, axis=AX)
        throttle = ms.veh_throttle.index_select(-1, vidx)
        f_drive = throttle * d.veh_torque[vidx] / torch.clamp_min(radius, 1e-3) * grounded
        v_side = torch.sum(cvel * side_s, dim=AX)
        f_lat = torch.minimum(torch.maximum(-v_side / torch.clamp_min(dt, 1e-4) * 80.0,
                                            -1.2 * f_spring), 1.2 * f_spring)
        imp = (up * f_spring.unsqueeze(AX) + dirv * f_drive.unsqueeze(AX)
               + side_s * f_lat.unsqueeze(AX)) * dt * wm
        acc = _scatter(torch.cat([imp, lm.cross(r, imp, axis=AX)], dim=AX), bidx, nb)  # [..,6,NB]
        iiw = P.inv_inertia_world_diag(rot, d.inv_inertia_body)
        return vel + acc[..., 0:3, :] * d.inv_mass[None, :], angvel + acc[..., 3:6, :] * iiw

    def move_controller(self, state: WorldState, entity: int, disp) -> WorldState:
        """Queue a displacement [3] (or [..., 3] over the world batch) for a
        character controller; the next `update` applies it."""
        slot = self.controllers.slot_of(entity)
        ms: PhysicsState = state.modules[self.name]
        cd = ms.ctrl_disp.clone()
        cd[..., :, slot] += torch.as_tensor(disp, dtype=torch.float32, device=cd.device)
        return state.replace(modules={**state.modules, self.name: ms.replace(ctrl_disp=cd)})

    def _update_controllers(self, state: WorldState, st: PhysStatics, d, ms: PhysicsState, dt):
        """The character controllers: their own gravity, the queued move, the
        clamp to the heightfield (or the ground plane's height), and their
        entities' local positions."""
        vy = ms.ctrl_vel_y + d.ctrl_gravity * dt
        pos = ms.ctrl_pos + ms.ctrl_disp
        py = pos[..., 1, :] + vy * dt
        if st.heightfield_terrain >= 0:
            from lumixengine_tpu_torch.renderer import terrain as terr

            ox, oy, oz = st.heightfield_origin
            gy = terr.sample_height(self._terrain_bank(pos.device), st.heightfield_terrain,
                                    pos[..., 0, :] - ox, pos[..., 2, :] - oz) + oy
        else:
            gy = torch.full_like(py, self.system.ground_y)
        below = py <= gy
        grounded = below & d.ctrl_mask
        pos = torch.stack([pos[..., 0, :], torch.where(below, gy, py), pos[..., 2, :]], dim=AX)
        ms = ms.replace(ctrl_pos=torch.where(d.ctrl_mask[None, :], pos, ms.ctrl_pos),
                        ctrl_vel_y=torch.where(d.ctrl_mask, torch.where(grounded, 0.0, vy),
                                               ms.ctrl_vel_y),
                        ctrl_disp=torch.zeros_like(ms.ctrl_disp), ctrl_grounded=grounded)
        local = state.local.replace(pos=state.local.pos.index_copy(
            -1, d.ctrl_slots, ms.ctrl_pos.index_select(-1, d.ctrl_cols)))
        return state.replace(local=local), ms

    def update(self, state: WorldState, dt) -> WorldState:
        """Step the character controllers, then write them and the dynamic
        bodies' poses into their entities' local transforms (propagation
        follows)."""
        st = self.statics()
        ms: PhysicsState = state.modules[self.name]
        d = st.on(ms.pos.device, self.system)
        if st.ctrl_mask.any():
            dt = torch.as_tensor(dt, dtype=torch.float32, device=ms.pos.device)
            state, ms = self._update_controllers(state, st, d, ms, dt)
            state = state.replace(modules={**state.modules, self.name: ms})
        if d.dyn_cols.numel() == 0:
            return state
        local = state.local.replace(
            pos=state.local.pos.index_copy(-1, d.dyn_slots, ms.pos.index_select(-1, d.dyn_cols)),
            rot=state.local.rot.index_copy(-1, d.dyn_slots, ms.rot.index_select(-1, d.dyn_cols)),
        )
        return state.replace(local=local)

    # -- queries ------------------------------------------------------------------

    def _query_setup(self, ms: PhysicsState, origin, layer_mask: int):
        """(statics, device statics, origin tensor, pos, rot, actor mask):
        rays [..., R, 3] beyond the state's batch axes see the state once."""
        st = self.statics()
        d = st.on(ms.pos.device, self.system)
        o = torch.as_tensor(origin, dtype=torch.float32, device=ms.pos.device)
        batch = ms.pos.shape[:-2]
        extra = max(o.dim() - 1 - len(batch), 0)
        pos = ms.pos.reshape(batch + (1,) * extra + ms.pos.shape[-2:])
        rot = ms.rot.reshape(batch + (1,) * extra + ms.rot.shape[-2:])
        if layer_mask == -1:
            mask = d.occ
        else:
            if layer_mask not in d.layer_masks:
                d.layer_masks[layer_mask] = d.occ & torch.as_tensor(
                    ((1 << st.layer) & layer_mask) != 0, device=ms.pos.device)
            mask = d.layer_masks[layer_mask]
        return st, d, o, pos, rot, mask

    def raycast(self, ms: PhysicsState, origin, direction, layer_mask: int = -1):
        """Rays against every actor: spheres and capsules as spheres exactly,
        boxes by slab tests, hulls exactly by slab clipping over their face
        axes. origin/direction [..., 3] or [..., R, 3] over the state's
        batch; → (hit, t, body slot)."""
        st, d, o, pos, rot, mask = self._query_setup(ms, origin, layer_mask)
        dvec = torch.as_tensor(direction, dtype=torch.float32, device=o.device)
        hit, t, idx = P.raycast_all(o, dvec, pos, rot, d.shape, d.radius, d.he, mask & ~d.is_convex)
        if st.has_convex:
            hc, tc, ic = CV.raycast_convex(o, dvec, pos, rot, d.poly_axes, d.poly_axis_lo,
                                           d.poly_axis_hi, mask & d.is_convex)
            pick_c = tc < t
            hit, t = hit | hc, torch.minimum(t, tc)
            idx = torch.where(pick_c, ic, idx)
        return hit, t, idx

    def sweep(self, ms: PhysicsState, origin, direction, sweep_radius: float,
              layer_mask: int = -1):
        """A sphere of `sweep_radius` swept along the rays against every
        actor (shapes as in physics_ops.sweep); → (hit, t, body slot)."""
        _st, d, o, pos, rot, mask = self._query_setup(ms, origin, layer_mask)
        dvec = torch.as_tensor(direction, dtype=torch.float32, device=o.device)
        return P.sweep(o, dvec, float(sweep_radius), pos, rot, d.shape, d.radius, d.he, mask)


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
