"""AnimationModule + AnimationSystem (counterpart of
``lumixengine_tpu/animation/module.py``).

Components: ``animable`` (one looping clip: advance the clock modulo the
clip length, sample, compute absolute, build the palette), ``animator``
(a controller graph → blend slots → sampled, blended pose, the controller's
IK chains, root motion applied to the entity's local transform) and
``property_animator`` (keyframe curves on the world's time driving a point
light's intensity or range, a camera's fov, or an entity's local position
and scale rows). Animators run in ``update_parallel``; animables, then the
property animators, in ``update``.

Animators and animables are grouped on the host by (model, controller) and
by model; each group is a static column range of the pose pool [..., C, B, P]
in the module state (animables first, then animators). Per frame and group:
sampling is a two-frame gather + lerp per blend slot (ops/sampling.py), the
blend a sequential nlerp over the slots (ops/pose.py), the absolute pose a
level scan over the skeleton, FABRIK on each IK chain of the controller
(ops/ik.py: the chain's joints set to the solution, each joint's rotation
delta composed into its absolute rotation), the palette one
dual-quaternion pass (ops/skinning.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from lumixengine_tpu_torch.animation.animation import ClipRegistry
from lumixengine_tpu_torch.animation.controller import Controller
from lumixengine_tpu_torch.core import math as lm
from lumixengine_tpu_torch.core import profiler
from lumixengine_tpu_torch.engine.plugin import IModule, ISystem
from lumixengine_tpu_torch.engine.world import World, WorldState
from lumixengine_tpu_torch.ops import ik as ik_ops
from lumixengine_tpu_torch.ops import pose as pose_ops
from lumixengine_tpu_torch.ops import sampling, skinning
from lumixengine_tpu_torch.utils.store import DenseStore

# (component, property) → the RenderState field and the renderer store whose
# slot indexes it: the device rows a property animator drives
_DEVICE_PROP_TARGETS = {
    ("point_light", "intensity"): ("pl_intensity", "point_lights"),
    ("point_light", "range"): ("pl_range", "point_lights"),
    ("camera", "fov"): ("cam_fov", "cameras"),
}

# transform channels animate the entity's local rows (field, component)
_TRANSFORM_TARGETS = {
    ("transform", "x"): ("pos", 0),
    ("transform", "y"): ("pos", 1),
    ("transform", "z"): ("pos", 2),
    ("transform", "scale_x"): ("scale", 0),
    ("transform", "scale_y"): ("scale", 1),
    ("transform", "scale_z"): ("scale", 2),
}


def interp(x, xp, fp):
    """np.interp / jnp.interp of x at the knots xp (ascending) with values
    fp, the ends held outside, in jnp.interp's formula."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[-1] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@dataclass
class AnimState:
    an_time: torch.Tensor       # f32 [A1] animable clocks
    ctrl_inputs: torch.Tensor   # f32 [I, A2] controller inputs (columns = animators)
    ctrl_clocks: torch.Tensor   # f32 [T, A2] per-node clocks
    pose_pos: torch.Tensor      # f32 [3, B, P] final model-space pose pool
    pose_rot: torch.Tensor      # f32 [4, B, P]
    palette: torch.Tensor       # f32 [8, B, P] dual-quat skinning palettes
    pa_enabled: torch.Tensor    # bool [PA] property-animator enable flags
    counters: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "AnimState":
        return dataclasses.replace(self, **kw)


class AnimStatics:
    """Host constants: group layouts, entity slots, bone plans, inverse binds;
    their tensors per device (``on``)."""

    def __init__(self, module: "AnimationModule"):
        w = module.world
        rmod = w.modules.get("renderer")
        models = module.system.renderer.models if module.system.renderer else None

        def model_of(entity: int) -> int:
            if rmod is None or entity < 0 or entity not in rmod.model_instances:
                return 0
            return int(rmod.model_instances.get(entity, "model"))

        def skeleton_data(mid: int):
            """Bone data padded to the clip bank's bone count (identity pads)."""
            b = module.system.max_bones
            parent = np.full(b, -1, np.int32)
            ibp = np.zeros((3, b), np.float32)
            ibr = np.tile(np.array([[0.0], [0.0], [0.0], [1.0]], np.float32), (1, b))
            mdl = models.get(mid) if models else None
            sk = mdl.skeleton if (mdl and mdl.skeleton) else None
            if sk is not None:
                nb = min(sk.bone_count, b)
                parent[:nb] = sk.bone_parent[:nb]
                p, r = sk.inverse_bind()
                ibp[:, :nb] = p[:nb].T
                ibr[:, :nb] = r[:nb].T
            return parent, ibp, ibr

        clip_length = module.system.bank_statics.clip_length
        # animable groups by model
        self.an_groups = []
        ents = module.animables.entity
        by_model: Dict[int, List[int]] = {}
        for slot in range(module.animables.capacity):
            if ents[slot] >= 0:
                by_model.setdefault(model_of(int(ents[slot])), []).append(slot)
        for mid, slots in sorted(by_model.items()):
            bp, ibp, ibr = skeleton_data(mid)
            s = np.asarray(slots)
            clips = np.asarray(module.animables.data["clip"][s], np.int32)
            self.an_groups.append(dict(
                model=mid, cols=s.astype(np.int32), entity_slots=w.to_slots(ents[s]),
                clips=clips, scale=np.asarray(module.animables.data["time_scale"][s], np.float32),
                lengths=clip_length[np.maximum(clips, 0)],
                plan=pose_ops.BonePlan(bp), inv_bind_pos=ibp, inv_bind_rot=ibr))
        # animator groups by (model, controller)
        self.at_groups = []
        ents = module.animators.entity
        by_key: Dict[tuple, List[int]] = {}
        for slot in range(module.animators.capacity):
            if ents[slot] >= 0:
                cid = int(module.animators.data["controller"][slot])
                by_key.setdefault((model_of(int(ents[slot])), cid), []).append(slot)
        for (mid, cid), slots in sorted(by_key.items()):
            bp, ibp, ibr = skeleton_data(mid)
            s = np.asarray(slots)
            self.at_groups.append(dict(
                model=mid, controller=module.system.controllers[cid],
                cols=s.astype(np.int32), entity_slots=w.to_slots(ents[s]),
                plan=pose_ops.BonePlan(bp), inv_bind_pos=ibp, inv_bind_rot=ibr))
        self.pool_offset = module.animables.capacity
        self._dev: Dict[str, SimpleNamespace] = {}

    def on(self, device) -> SimpleNamespace:
        """Per group, its index and constant tensors on `device`, built once."""
        key = str(torch.device(device))
        if key not in self._dev:
            def t(a, dtype=None):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

            def common(g, pool_cols):
                return dict(cols=t(g["cols"], torch.int64), pool_cols=t(pool_cols, torch.int64),
                            eslots=t(np.maximum(g["entity_slots"], 0), torch.int64),
                            ibp=t(g["inv_bind_pos"]), ibr=t(g["inv_bind_rot"]))

            self._dev[key] = SimpleNamespace(
                an=[SimpleNamespace(**common(g, g["cols"]), clips=t(g["clips"], torch.int64),
                                    scale=t(g["scale"]), lengths=t(g["lengths"]))
                    for g in self.an_groups],
                at=[SimpleNamespace(**common(g, self.pool_offset + g["cols"]))
                    for g in self.at_groups],
                quat_identity=t(np.array([[0.0], [0.0], [0.0], [1.0]], np.float32)))
        return self._dev[key]


class AnimationModule(IModule):
    name = "animation"
    # component type → its DenseStore attribute (the world blob's contract)
    COMPONENT_STORES = {"animable": "animables", "animator": "animators"}

    def __init__(self, world: World, system: "AnimationSystem",
                 max_animables: int = 1024, max_animators: int = 256,
                 max_controller_inputs: int = 8, build_palettes: bool = True):
        super().__init__(world, system)
        self.animables = DenseStore(max_animables, {
            "clip": ((), np.int32, -1), "time_scale": ((), np.float32, 1.0),
            "start_time": ((), np.float32, 0.0)})
        self.animators = DenseStore(max_animators, {"controller": ((), np.int32, -1)})
        self.default_inputs = np.zeros((max_controller_inputs, max_animators), np.float32)
        self.property_animators: Dict[int, list] = {}
        self.pa_default_enabled: Dict[int, bool] = {}
        self._curves: Dict[str, dict] = {}   # device → {(entity, curve index): (times, values)}
        # False: the phases leave `palette` as it was (a caller that skins
        # from the poses itself saves the dual-quaternion pass)
        self.build_palettes = build_palettes
        self._statics: Optional[AnimStatics] = None
        self._statics_version = -1

    # -- components -----------------------------------------------------------

    def component_types(self):
        return ["animable", "animator", "property_animator"]

    def create_component(self, entity: int, ctype: str, **props):
        self.invalidate_statics()
        if ctype == "animable":
            clip = props.get("clip", -1)
            if isinstance(clip, str):
                clip = self.system.clips.get_id(clip)
            self.animables.add(entity, clip=np.int32(clip),
                               time_scale=np.float32(props.get("time_scale", 1.0)),
                               start_time=np.float32(props.get("start_time", 0.0)))
        elif ctype == "animator":
            ctrl = props.get("controller", -1)
            if isinstance(ctrl, str):
                ctrl = self.system.controller_id(ctrl)
            slot = self.animators.add(entity, controller=np.int32(ctrl))
            for name, v in props.get("inputs", {}).items():
                c = self.system.controllers[int(ctrl)]
                self.default_inputs[c.input_index(name), slot] = np.float32(v)
        elif ctype == "property_animator":
            # keyframe curves, each on one device row (_DEVICE_PROP_TARGETS,
            # _TRANSFORM_TARGETS); other properties have no device row
            curves = []
            for cur in props.get("curves", []):
                curves.append({"component": cur["component"], "property": cur["property"],
                               "times": np.asarray(cur["times"], np.float32),
                               "values": np.asarray(cur["values"], np.float32)})
                key = (cur["component"], cur["property"])
                if key not in _DEVICE_PROP_TARGETS and key not in _TRANSFORM_TARGETS:
                    raise KeyError(
                        f"property_animator target {cur['component']}.{cur['property']}"
                        " has no device row (host-side reflection animation instead)")
            self.property_animators[entity] = curves
            self.pa_default_enabled[entity] = bool(props.get("enabled", True))
            self._curves.clear()
        else:
            raise KeyError(ctype)

    def destroy_component(self, entity: int, ctype: str) -> None:
        self.invalidate_statics()
        if ctype == "animable":
            self.animables.remove(entity)
        elif ctype == "animator":
            self.animators.remove(entity)
        elif ctype == "property_animator":
            self.property_animators.pop(entity, None)
            self._curves.clear()

    def set_animator_input(self, entity: int, name: str, value: float) -> None:
        """The animator's host default for input `name` of its controller;
        the next device_state carries it (a running state's inputs are
        AnimState.ctrl_inputs)."""
        slot = self.animators.slot_of(entity)
        c = self.system.controllers[int(self.animators.data["controller"][slot])]
        self.default_inputs[c.input_index(name), slot] = np.float32(value)

    # -- serialization ------------------------------------------------------------

    def serialize(self):
        """The world blob's module section: each animator's controller
        inputs, keyed by its entity."""
        out = {}
        for slot in range(self.animators.capacity):
            e = int(self.animators.entity[slot])
            if e >= 0:
                out[str(e)] = self.default_inputs[:, slot].tolist()
        return {"animator_inputs": out}

    def deserialize(self, blob, emap):
        for old_str, vals in blob.get("animator_inputs", {}).items():
            new = emap.get(int(old_str))
            if new < 0:
                continue
            slot = self.animators.slot_of(new)
            if slot >= 0:
                self.default_inputs[: len(vals), slot] = vals

    # -- statics / state --------------------------------------------------------

    def invalidate_statics(self) -> None:
        """Drop the group statics and the tensors cached on them; the next
        statics() regroups from the stores (a reflected property edit calls
        this)."""
        self._statics = None

    def statics(self) -> AnimStatics:
        self.world._refresh_levels()
        if self._statics is None or self._statics_version != self.world.topology_version:
            self._statics = AnimStatics(self)
            self._statics_version = self.world.topology_version
        return self._statics

    def prepare_statics(self, device) -> None:
        self.statics().on(device)
        self.system.bank.on(device)
        self.system.bank_statics.on(device)

    @property
    def pool_size(self) -> int:
        return self.animables.capacity + self.animators.capacity

    def pool_col_animable(self, slot: int) -> int:
        """The pose-pool column of animable store slot `slot`."""
        return slot

    def pool_col_animator(self, slot: int) -> int:
        """The pose-pool column of animator store slot `slot` (animators
        follow the animables' columns)."""
        return self.animables.capacity + slot

    def device_state(self, device) -> AnimState:
        b = self.system.max_bones
        p = self.pool_size
        t_max = max([1] + [c.num_clocks for c in self.system.controllers])
        f32 = dict(dtype=torch.float32, device=device)
        pose_rot = torch.zeros((4, b, p), **f32)
        pose_rot[3] = 1.0
        palette = torch.zeros((8, b, p), **f32)
        palette[3] = 1.0
        return AnimState(
            an_time=torch.as_tensor(self.animables.data["start_time"].copy(), device=device),
            ctrl_inputs=torch.as_tensor(self.default_inputs.copy(), device=device),
            ctrl_clocks=torch.zeros((t_max, self.animators.capacity), **f32),
            pose_pos=torch.zeros((3, b, p), **f32),
            pose_rot=pose_rot,
            palette=palette,
            pa_enabled=torch.as_tensor([self.pa_default_enabled.get(e, True)
                                        for e in sorted(self.property_animators)] or [True],
                                       dtype=torch.bool, device=device),
            counters={"animated": torch.zeros((), dtype=torch.int32, device=device)},
        )

    # -- phases -----------------------------------------------------------------

    def update_parallel(self, state: WorldState, dt) -> WorldState:
        """Animators: controller → blend slots → pose, palette, root motion."""
        st = self.statics()
        ms: AnimState = state.modules[self.name]
        dev = ms.pose_pos.device
        d = st.on(dev)
        bank = self.system.bank.on(dev)
        bstat = self.system.bank_statics.on(dev)

        pose_pos, pose_rot, palette = ms.pose_pos, ms.pose_rot, ms.palette
        ctrl_clocks = ms.ctrl_clocks
        local = state.local

        for g, gd in zip(st.at_groups, d.at):
            ctrl: Controller = g["controller"]
            inputs_g = ms.ctrl_inputs.index_select(-1, gd.cols)[..., : max(ctrl.num_inputs, 1), :]
            clocks_g = ctrl_clocks.index_select(-1, gd.cols)
            slots, slot_masks, new_clocks = ctrl.eval(inputs_g, clocks_g[..., : ctrl.num_clocks, :],
                                                      dt)
            if ctrl.num_clocks:
                ctrl_clocks = ctrl_clocks.clone()
                ctrl_clocks[..., : ctrl.num_clocks, :] = ctrl_clocks[
                    ..., : ctrl.num_clocks, :].index_copy(-1, gd.cols, new_clocks)

            # the blend stack
            acc_pos = acc_rot = cum_w = root_dp = root_dr = any_rm = None
            for s, (clip, t, wgt, prev_t) in enumerate(slots):
                cid = torch.clamp_min(clip, 0)
                p_s, r_s = sampling.sample_clips(bank, t, clip, bstat)
                slot_rm = (bstat.clip_flags[cid] != 0) & (clip >= 0) & (wgt > 1e-6)
                any_rm = slot_rm if any_rm is None else (any_rm | slot_rm)
                # the slot's root-motion delta over this frame's clock advance;
                # when the clock wrapped, the rest of the loop plus the new lap
                rp_c, rr_c = sampling.sample_root_motion(bank, t, clip, bstat)
                rp_p, rr_p = sampling.sample_root_motion(bank, prev_t, clip, bstat)
                inv_pr = lm.quat_conjugate(rr_p, axis=-2)
                d_p = lm.quat_rotate(inv_pr, rp_c - rp_p, axis=-2)
                d_r = lm.quat_mul(inv_pr, rr_c, axis=-2)
                end_p = bstat.root_end_pos[:, cid]
                end_r = bstat.root_end_rot[:, cid]
                dw1_p = lm.quat_rotate(inv_pr, end_p - rp_p, axis=-2)
                dw1_r = lm.quat_mul(inv_pr, end_r, axis=-2)
                dw_p = dw1_p + lm.quat_rotate(dw1_r, rp_c, axis=-2)
                dw_r = lm.quat_mul(dw1_r, rr_c, axis=-2)
                wrapped = (t < prev_t).unsqueeze(-2)
                rm = slot_rm.unsqueeze(-2)
                dp_s = torch.where(wrapped, dw_p, d_p) * rm
                dr_s = torch.where(rm & wrapped, dw_r, torch.where(rm, d_r, d.quat_identity))
                if acc_pos is None:
                    acc_pos, acc_rot = p_s, r_s
                    cum_w = torch.clamp_min(wgt, 1e-6)
                    root_dp, root_dr = dp_s, dr_s
                else:
                    new_cum = cum_w + wgt
                    f = wgt / torch.clamp_min(new_cum, 1e-6)
                    if s in slot_masks:
                        acc_pos, acc_rot = pose_ops.masked_blend(acc_pos, acc_rot, p_s, r_s, f,
                                                                 slot_masks[s])
                    else:
                        acc_pos, acc_rot = pose_ops.blend(acc_pos, acc_rot, p_s, r_s, f)
                    root_dp = root_dp + (dp_s - root_dp) * f.unsqueeze(-2)
                    root_dr = lm.quat_nlerp(root_dr, dr_s, f, axis=-2)
                    cum_w = new_cum

            if acc_pos is None:
                continue
            apos, arot = pose_ops.compute_absolute(acc_pos, acc_rot, g["plan"])
            for ik_node in ctrl.ik_requests:
                apos, arot = self._ik_pass(ik_node, inputs_g, apos, arot)
            pose_pos = pose_pos.index_copy(-1, gd.pool_cols, apos)
            pose_rot = pose_rot.index_copy(-1, gd.pool_cols, arot)
            if self.build_palettes:
                with profiler.block("animation.palette"):
                    palette = palette.index_copy(
                        -1, gd.pool_cols, skinning.build_palette_dq(apos, arot, gd.ibp, gd.ibr))

            # root motion → entity local transform: pos += rot * delta.pos,
            # rot = normalize(rot * delta.rot)
            hm2 = any_rm.unsqueeze(-2)
            lp = local.pos.index_select(-1, gd.eslots)
            lr = local.rot.index_select(-1, gd.eslots)
            new_lp = lp + lm.quat_rotate(lr, root_dp, axis=-2)
            new_lr = lm.quat_normalize(lm.quat_mul(lr, root_dr, axis=-2), axis=-2)
            local = local.replace(
                pos=local.pos.index_copy(-1, gd.eslots, torch.where(hm2, new_lp, lp)),
                rot=local.rot.index_copy(-1, gd.eslots, torch.where(hm2, new_lr, lr)))

        ms = ms.replace(ctrl_clocks=ctrl_clocks, pose_pos=pose_pos, pose_rot=pose_rot,
                        palette=palette)
        return state.replace(local=local, modules={**state.modules, self.name: ms})

    @staticmethod
    def _ik_pass(ik_node, inputs_g, apos, arot):
        """One IK chain on a group's absolute pose [..., C, B, A]: FABRIK
        toward the target inputs, alpha-blended; the chain's joints take
        the solution and each joint but the effector composes its rotation
        delta into its absolute rotation."""
        chain = torch.as_tensor(np.asarray(ik_node.chain, np.int64), device=apos.device)
        target = torch.stack([inputs_g[..., i, :] for i in ik_node.target_inputs], dim=-2)
        if isinstance(ik_node.alpha, int) and not isinstance(ik_node.alpha, bool):
            alpha = inputs_g[..., ik_node.alpha, :]
        else:
            alpha = float(ik_node.alpha)
        joints = apos.index_select(-2, chain)
        solved = ik_ops.apply_ik(joints, target, alpha)
        deltas = ik_ops.chain_rotation_deltas(joints, solved)
        parents = chain[:-1]
        apos = apos.index_copy(-2, chain, solved)
        arot = arot.index_copy(-2, parents, lm.quat_mul(deltas, arot.index_select(-2, parents),
                                                        axis=-3))
        return apos, arot

    def update(self, state: WorldState, dt) -> WorldState:
        """Animables: advance the clock modulo the clip length, sample,
        compute absolute, build the palette."""
        st = self.statics()
        ms: AnimState = state.modules[self.name]
        dev = ms.pose_pos.device
        d = st.on(dev)
        bank = self.system.bank.on(dev)
        bstat = self.system.bank_statics.on(dev)

        an_time = ms.an_time
        pose_pos, pose_rot, palette = ms.pose_pos, ms.pose_rot, ms.palette
        total = 0
        for g, gd in zip(st.an_groups, d.an):
            t = torch.remainder(an_time.index_select(-1, gd.cols) + dt * gd.scale, gd.lengths)
            an_time = an_time.index_copy(-1, gd.cols, t)
            p, r = sampling.sample_clips(bank, t, gd.clips, bstat)
            apos, arot = pose_ops.compute_absolute(p, r, g["plan"])
            pose_pos = pose_pos.index_copy(-1, gd.pool_cols, apos)
            pose_rot = pose_rot.index_copy(-1, gd.pool_cols, arot)
            if self.build_palettes:
                with profiler.block("animation.palette"):
                    palette = palette.index_copy(
                        -1, gd.pool_cols, skinning.build_palette_dq(apos, arot, gd.ibp, gd.ibr))
            total += len(g["cols"])

        ms = ms.replace(an_time=an_time, pose_pos=pose_pos, pose_rot=pose_rot, palette=palette,
                        counters={**ms.counters,
                                  "animated": torch.full_like(ms.counters["animated"], total)})
        state = state.replace(modules={**state.modules, self.name: ms})
        if self.property_animators:
            state = self._property_animators(state, ms)
        return state

    def _curve(self, e: int, i: int, cur: dict, device):
        key = str(torch.device(device))
        bank = self._curves.setdefault(key, {})
        if (e, i) not in bank:
            bank[(e, i)] = (torch.as_tensor(cur["times"], device=device),
                            torch.as_tensor(cur["values"], device=device))
        return bank[(e, i)]

    def _property_animators(self, state: WorldState, ms: AnimState) -> WorldState:
        """Each curve at the world's time modulo its last key, written into
        its row where its animator is enabled: the renderer's point-light
        and camera rows, the entities' local position and scale rows."""
        rmod = self.world.modules.get("renderer")
        rs = state.modules.get("renderer")
        local = state.local
        rs_dirty = local_dirty = False
        pa_index = {e: i for i, e in enumerate(sorted(self.property_animators))}
        dev = ms.pose_pos.device
        for e, curves in self.property_animators.items():
            en = ms.pa_enabled[..., pa_index[e]]
            for i, cur in enumerate(curves):
                key = (cur["component"], cur["property"])
                times = cur["times"]
                dur = float(times[-1]) if len(times) else 1.0
                t = torch.remainder(state.time, np.float32(max(dur, 1e-6)))
                v = interp(t, *self._curve(e, i, cur, dev))
                if key in _TRANSFORM_TARGETS:
                    field, axis = _TRANSFORM_TARGETS[key]
                    slot = self.world.slot(e)
                    if slot < 0:
                        continue
                    arr = getattr(local, field).clone()
                    arr[..., axis, slot] = torch.where(en, v, arr[..., axis, slot])
                    local = local.replace(**{field: arr})
                    local_dirty = True
                elif rs is not None:
                    field, store_name = _DEVICE_PROP_TARGETS[key]
                    slot = getattr(rmod, store_name).slot_of(e)
                    if slot < 0:
                        continue
                    arr = getattr(rs, field).clone()
                    arr[..., slot] = torch.where(en, v, arr[..., slot])
                    rs = rs.replace(**{field: arr})
                    rs_dirty = True
        if local_dirty:
            state = state.replace(local=local)
        if rs_dirty:
            state = state.replace(modules={**state.modules, "renderer": rs})
        return state


class AnimationSystem(ISystem):
    """Owns the clip and controller resources."""

    name = "animation_system"

    def __init__(self, engine, renderer=None, max_bones: int = 32):
        super().__init__(engine)
        self.clips = ClipRegistry()
        self.controllers: List[Controller] = []
        self._ctrl_by_name: Dict[str, int] = {}
        self.renderer = renderer
        self._max_bones = max_bones   # the clip bank's bone rows, at least
        self._bank = None
        self._bank_statics = None

    @property
    def max_bones(self) -> int:
        if self.renderer is not None and len(self.renderer.models):
            return max(self._max_bones, self.renderer.bake().max_bones)
        return self._max_bones

    def add_clip(self, clip) -> int:
        self._bank = None
        return self.clips.add(clip)

    def add_controller(self, ctrl: Controller) -> int:
        cid = len(self.controllers)
        self.controllers.append(ctrl)
        self._ctrl_by_name[ctrl.name] = cid
        return cid

    def controller_id(self, name: str) -> int:
        return self._ctrl_by_name[name]

    @property
    def bank(self):
        if self._bank is None:
            self._bank, self._bank_statics = self.clips.bake(self.max_bones)
        return self._bank

    @property
    def bank_statics(self):
        _ = self.bank
        return self._bank_statics

    def create_modules(self, world: World) -> AnimationModule:
        caps = getattr(self.engine, "module_capacities", {})
        return AnimationModule(world, self, max_animables=caps.get("animables", 1024),
                               max_animators=caps.get("animators", 256))
