"""Animation clip resources (counterpart of
``lumixengine_tpu/animation/animation.py``).

Clips are baked DENSE into a ClipBank: one [7·B, CF] table (7 channels ×
padded bones as rows; all clips' frames concatenated as columns) and a
[7, CF] root-motion track. Quats are made sign-coherent along time at bake
(q[f+1]·q[f] ≥ 0), which makes lerp+normalize of two frames an nlerp.
The host side (numpy) is the reference's, draw for draw.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from lumixengine_tpu_torch.core import host_math as hm

# root motion flags
Y_ROOT_TRANSLATION = 1 << 0
XZ_ROOT_TRANSLATION = 1 << 1
ROOT_ROTATION = 1 << 2
ANY_ROOT_MOTION = Y_ROOT_TRANSLATION | XZ_ROOT_TRANSLATION | ROOT_ROTATION


@dataclass
class Clip:
    """Host clip: dense local-space bone tracks.

    pos: f32 [F, B, 3], rot: f32 [F, B, 4] (x,y,z,w). F frames at `fps`;
    length = (F-1)/fps seconds (last frame is the loop end)."""

    name: str
    pos: np.ndarray
    rot: np.ndarray
    fps: float = 30.0
    flags: int = 0
    root_bone: int = 0

    def __post_init__(self):
        self.pos = np.asarray(self.pos, np.float32)
        self.rot = np.asarray(self.rot, np.float32)
        assert self.pos.ndim == 3 and self.pos.shape[-1] == 3
        assert self.rot.shape == self.pos.shape[:2] + (4,)
        # sign-coherence along time so lerp+normalize == nlerp
        r = self.rot
        for f in range(1, r.shape[0]):
            dots = np.sum(r[f] * r[f - 1], axis=-1, keepdims=True)
            r[f] = np.where(dots < 0, -r[f], r[f])
        self.rot = hm.quat_normalize(r)

    @property
    def frame_count(self) -> int:
        return int(self.pos.shape[0])

    @property
    def bone_count(self) -> int:
        return int(self.pos.shape[1])

    @property
    def length_seconds(self) -> float:
        return max(self.frame_count - 1, 1) / self.fps


class ClipBank:
    """The baked clip bank (host numpy) and its tensors per device.

    table: f32 [7*B, CF] — rows are (px,py,pz,qx,qy,qz,qw) × B bones; columns
    are all clips' frames concatenated. root_motion: f32 [7, CF], the root
    bone's delta against frame 0 (pos + rot) per frame."""

    def __init__(self, table: np.ndarray, root_motion: np.ndarray):
        self.table = table
        self.root_motion = root_motion
        self._dev: Dict[str, SimpleNamespace] = {}

    def on(self, device) -> SimpleNamespace:
        """``table_t`` [CF, 7*B] and ``root_t`` [CF, 7] (frame-major, for
        the frame gathers of ops/sampling.py) on `device`, built once."""
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = SimpleNamespace(
                table_t=torch.as_tensor(np.ascontiguousarray(self.table.T), device=device),
                root_t=torch.as_tensor(np.ascontiguousarray(self.root_motion.T), device=device))
        return self._dev[key]


class ClipBankStatics:
    """Host metadata: per-clip frame offsets, frame counts, fps, lengths,
    root-motion flags and root-track end transforms."""

    def __init__(self, clips: List[Clip], max_bones: int):
        self.max_bones = int(max_bones)
        self.clip_offset = np.zeros(len(clips), np.int32)
        self.clip_frames = np.zeros(len(clips), np.int32)
        self.clip_fps = np.zeros(len(clips), np.float32)
        self.clip_length = np.zeros(len(clips), np.float32)
        self.clip_flags = np.zeros(len(clips), np.int32)
        self.root_end_pos = np.zeros((len(clips), 3), np.float32)
        self.root_end_rot = np.tile(np.array([0, 0, 0, 1], np.float32), (len(clips), 1))
        off = 0
        for i, c in enumerate(clips):
            self.clip_offset[i] = off
            self.clip_frames[i] = c.frame_count
            self.clip_fps[i] = c.fps
            self.clip_length[i] = c.length_seconds
            self.clip_flags[i] = c.flags
            off += c.frame_count
        self.total_frames = off
        self._dev: Dict[str, SimpleNamespace] = {}

    def on(self, device) -> SimpleNamespace:
        """The per-clip tables as tensors on `device` (built once): offsets
        and frame counts int64, fps, lengths, root-motion flags, and the
        root track's end transforms as [3, C] / [4, C]."""
        key = str(torch.device(device))
        if key not in self._dev:
            def t(a, dtype=None):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

            self._dev[key] = SimpleNamespace(
                clip_offset=t(self.clip_offset, torch.int64),
                clip_frames=t(self.clip_frames, torch.int64),
                clip_fps=t(self.clip_fps), clip_length=t(self.clip_length),
                clip_flags=t(self.clip_flags),
                root_end_pos=t(self.root_end_pos.T), root_end_rot=t(self.root_end_rot.T))
        return self._dev[key]


class ClipRegistry:
    """Host registry: clip name → id; bakes the ClipBank."""

    def __init__(self):
        self.clips: List[Clip] = []
        self._by_name: Dict[str, int] = {}

    def add(self, clip: Clip) -> int:
        if clip.name in self._by_name:
            raise ValueError(f"duplicate clip {clip.name!r}")
        cid = len(self.clips)
        self.clips.append(clip)
        self._by_name[clip.name] = cid
        return cid

    def get_id(self, name: str) -> int:
        return self._by_name[name]

    def bake(self, max_bones: int):
        """→ (ClipBank, ClipBankStatics). Bones padded to max_bones with
        identity transforms."""
        clips = self.clips if self.clips else [
            Clip(name="__empty", pos=np.zeros((2, 1, 3), np.float32),
                 rot=np.tile(hm.QUAT_IDENTITY, (2, 1, 1)))
        ]
        statics = ClipBankStatics(clips, max_bones)
        cf = statics.total_frames
        b = max_bones
        table = np.zeros((7 * b, cf), np.float32)
        # identity rot w for padded bones so un-animated bones stay valid
        table.reshape(7, b, cf)[6, :, :] = 1.0
        root = np.zeros((7, cf), np.float32)
        root[6] = 1.0
        for i, c in enumerate(clips):
            o = statics.clip_offset[i]
            f = c.frame_count
            nb = min(c.bone_count, b)
            v = table.reshape(7, b, cf)
            v[0:3, :nb, o : o + f] = np.transpose(c.pos[:, :nb, :], (2, 1, 0))
            v[3:7, :nb, o : o + f] = np.transpose(c.rot[:, :nb, :], (2, 1, 0))
            # root motion: delta of root bone vs frame 0 (the reference's getRootMotion)
            rb = min(c.root_bone, nb - 1)
            p0, r0 = c.pos[0, rb], c.rot[0, rb]
            inv_r0 = hm.quat_conjugate(r0)
            dp = c.pos[:, rb, :] - p0
            dr = hm.quat_mul(np.broadcast_to(inv_r0, (f, 4)), c.rot[:, rb, :])
            mask_y = bool(c.flags & Y_ROOT_TRANSLATION)
            mask_xz = bool(c.flags & XZ_ROOT_TRANSLATION)
            mask_rot = bool(c.flags & ROOT_ROTATION)
            root[0, o : o + f] = dp[:, 0] if mask_xz else 0.0
            root[1, o : o + f] = dp[:, 1] if mask_y else 0.0
            root[2, o : o + f] = dp[:, 2] if mask_xz else 0.0
            if mask_rot:
                root[3:7, o : o + f] = dr.T
            else:
                root[3:6, o : o + f] = 0.0
                root[6, o : o + f] = 1.0
            statics.root_end_pos[i] = root[0:3, o + f - 1]
            statics.root_end_rot[i] = root[3:7, o + f - 1]
        return ClipBank(table, root), statics


def make_walk_clip(skeleton, name: str = "walk", frames: int = 31, fps: float = 30.0,
                   amplitude: float = 0.4, seed: int = 0, flags: int = 0,
                   root_speed: float = 1.2) -> Clip:
    """Procedural looping clip over a Skeleton: bind pose + per-bone sinusoidal
    swing with random phase (stands in for imported clips in demos/benches).
    Clips with root-motion flags get linear root travel along -Z at
    `root_speed` m/s, which the engine extracts as root motion."""
    rng = np.random.default_rng(seed)
    b = skeleton.bone_count
    pos = np.tile(skeleton.bind_pos[None], (frames, 1, 1)).astype(np.float32)
    if flags & ANY_ROOT_MOTION:
        travel = np.arange(frames, dtype=np.float32) / fps * root_speed
        if flags & XZ_ROOT_TRANSLATION:
            pos[:, 0, 2] -= travel
        if flags & Y_ROOT_TRANSLATION:
            pos[:, 0, 1] += 0.05 * np.sin(2 * np.pi * np.arange(frames) / (frames - 1))
    rot = np.zeros((frames, b, 4), np.float32)
    phase = rng.uniform(0, 2 * np.pi, b)
    axes = rng.normal(size=(b, 3)).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    amp = rng.uniform(0.2, 1.0, b) * amplitude
    for f in range(frames):
        t = 2 * np.pi * f / (frames - 1)  # exactly periodic for looping
        ang = np.sin(t + phase) * amp
        sw = hm.quat_from_axis_angle(axes, ang.astype(np.float32))
        rot[f] = hm.quat_mul(skeleton.bind_rot, sw)
    return Clip(name=name, pos=pos, rot=rot, fps=fps, flags=flags)
