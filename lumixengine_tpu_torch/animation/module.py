"""AnimationModule + AnimationSystem (counterpart of
``lumixengine_tpu/animation/module.py``).

Components: ``animable`` (one looping clip: advance the clock modulo the
clip length, sample, compute absolute, build the palette) and ``animator``
(a controller graph → blend slots → sampled, blended pose + root motion
applied to the entity's local transform). Animators run in
``update_parallel``, animables in ``update``.

Animators and animables are grouped on the host by (model, controller) and
by model; each group is a static column range of the pose pool [..., C, B, P]
in the module state (animables first, then animators). Per frame and group:
sampling is a two-frame gather + lerp per blend slot (ops/sampling.py), the
blend a sequential nlerp over the slots (ops/pose.py), the absolute pose a
level scan over the skeleton, the palette one dual-quaternion pass
(ops/skinning.py). ``property_animator`` and IK raise NotImplementedError.
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
from lumixengine_tpu_torch.engine.plugin import IModule, ISystem
from lumixengine_tpu_torch.engine.world import World, WorldState
from lumixengine_tpu_torch.ops import pose as pose_ops
from lumixengine_tpu_torch.ops import sampling, skinning
from lumixengine_tpu_torch.utils.store import DenseStore

MAX_CONTROLLER_INPUTS = 8


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

    def __init__(self, world: World, system: "AnimationSystem",
                 max_animables: int = 1024, max_animators: int = 256):
        super().__init__(world, system)
        self.animables = DenseStore(max_animables, {
            "clip": ((), np.int32, -1), "time_scale": ((), np.float32, 1.0),
            "start_time": ((), np.float32, 0.0)})
        self.animators = DenseStore(max_animators, {"controller": ((), np.int32, -1)})
        self.default_inputs = np.zeros((MAX_CONTROLLER_INPUTS, max_animators), np.float32)
        self._statics: Optional[AnimStatics] = None
        self._statics_version = -1

    # -- components -----------------------------------------------------------

    def component_types(self):
        return ["animable", "animator", "property_animator"]

    def create_component(self, entity: int, ctype: str, **props):
        self._statics = None
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
        else:
            raise NotImplementedError(f"animation component {ctype!r} is not ported")

    # -- statics / state --------------------------------------------------------

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
            pa_enabled=torch.ones(1, dtype=torch.bool, device=device),
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
            pose_pos = pose_pos.index_copy(-1, gd.pool_cols, apos)
            pose_rot = pose_rot.index_copy(-1, gd.pool_cols, arot)
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
            palette = palette.index_copy(
                -1, gd.pool_cols, skinning.build_palette_dq(apos, arot, gd.ibp, gd.ibr))
            total += len(g["cols"])

        ms = ms.replace(an_time=an_time, pose_pos=pose_pos, pose_rot=pose_rot, palette=palette,
                        counters={**ms.counters,
                                  "animated": torch.full_like(ms.counters["animated"], total)})
        return state.replace(modules={**state.modules, self.name: ms})


class AnimationSystem(ISystem):
    """Owns the clip and controller resources."""

    name = "animation_system"

    MIN_BONES = 32  # the clip bank's bone rows, at least

    def __init__(self, engine, renderer=None):
        super().__init__(engine)
        self.clips = ClipRegistry()
        self.controllers: List[Controller] = []
        self._ctrl_by_name: Dict[str, int] = {}
        self.renderer = renderer
        self._bank = None
        self._bank_statics = None

    @property
    def max_bones(self) -> int:
        if self.renderer is not None and len(self.renderer.models):
            return max(self.MIN_BONES, self.renderer.bake().max_bones)
        return self.MIN_BONES

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
