"""The scenes' recipes as plain data: the benchmark's inputs, drawn from the
seed with numpy's generator in the order the deployment's published scene
builders draw them (BASELINE's configs 2 and 5, as the port's
``models/demo_scenes.py`` builds them), so that one seed gives one scene on
both sides. Nothing here simulates; ``model.py`` does.

A scene is a table of entities (parent, local transform, alive), its
components in creation order (which is their store slots' order), the
models, one humanoid skeleton and its three clips.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], np.float32)

# models: name -> (bounding radius, LOD switch distances); ids in this order
MODELS = {"cube": (0.87, (np.inf,) * 4), "rock": (1.5, (20.0, 60.0, 150.0, np.inf)),
          "tree": (4.0, (40.0, 120.0, np.inf, np.inf)), "character": (1.2, (np.inf,) * 4)}
MODEL_ID = {n: i for i, n in enumerate(MODELS)}

BONES = 32
XZ_ROOT = 2           # the clip flag: the root bone's x and z travel is root motion
SHAPE_SPHERE, SHAPE_BOX = 0, 1


# -- host quaternion algebra (numpy, float32, components last) --------------------

def q_mul(a, b):
    ax, ay, az, aw = (a[..., i] for i in range(4))
    bx, by, bz, bw = (b[..., i] for i in range(4))
    return np.stack([aw * bx + ax * bw + ay * bz - az * by, aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw, aw * bw - ax * bx - ay * by - az * bz],
                    axis=-1).astype(np.float32)


def q_conj(q):
    return (np.asarray(q) * np.array([-1.0, -1.0, -1.0, 1.0], np.float32)).astype(np.float32)


def q_rot(q, v):
    q, v = np.asarray(q, np.float32), np.asarray(v, np.float32)
    t = 2.0 * np.cross(q[..., :3], v)
    return (v + q[..., 3:4] * t + np.cross(q[..., :3], t)).astype(np.float32)


def q_normalize(q):
    q = np.asarray(q, np.float32)
    return q / np.sqrt(np.maximum(np.sum(q * q, axis=-1, keepdims=True), 1e-24))


def q_axis_angle(axis, angle):
    axis = np.asarray(axis, np.float32)
    half = np.asarray(angle, np.float32) * 0.5
    return np.concatenate([axis * np.sin(half)[..., None], np.cos(half)[..., None]],
                          axis=-1).astype(np.float32)


# -- assets -----------------------------------------------------------------------

@dataclass
class Skeleton:
    parent: np.ndarray     # int32 [B], parents before children
    bind_pos: np.ndarray   # f32 [B, 3] local bind translation
    bind_rot: np.ndarray   # f32 [B, 4]

    def inverse_bind(self):
        """The inverse of each bone's model-space bind transform: (pos [B, 3], rot [B, 4])."""
        b = len(self.parent)
        ap, ar = np.zeros((b, 3), np.float32), np.zeros((b, 4), np.float32)
        for i in range(b):
            p = self.parent[i]
            if p < 0:
                ap[i], ar[i] = self.bind_pos[i], self.bind_rot[i]
            else:
                ap[i] = ap[p] + q_rot(ar[p], self.bind_pos[i] * np.ones(3, np.float32))
                ar[i] = q_mul(ar[p], self.bind_rot[i])
        inv_r = q_conj(ar)
        return q_rot(inv_r, -ap), inv_r


def humanoid_skeleton(num_bones: int = BONES, seed: int = 7) -> Skeleton:
    """Chains off a root; each bone hangs from one of the four before it."""
    rng = np.random.default_rng(seed)
    parent = np.full(num_bones, -1, np.int32)
    pos = np.zeros((num_bones, 3), np.float32)
    rot = np.tile(IDENTITY, (num_bones, 1))
    for i in range(1, num_bones):
        parent[i] = rng.integers(max(0, i - 4), i)
        pos[i] = rng.normal(0, 0.15, 3).astype(np.float32) + np.array([0, 0.25, 0], np.float32)
        axis = rng.normal(size=3).astype(np.float32)
        axis /= np.linalg.norm(axis)
        rot[i] = q_axis_angle(axis, rng.uniform(-0.3, 0.3))
    return Skeleton(parent, pos, rot)


@dataclass
class Clip:
    pos: np.ndarray     # f32 [F, B, 3] local bone tracks
    rot: np.ndarray     # f32 [F, B, 4], sign-coherent along time, unit length
    fps: float
    flags: int

    @property
    def frames(self) -> int:
        return self.pos.shape[0]

    @property
    def length(self) -> np.float32:
        return np.float32(max(self.frames - 1, 1) / self.fps)


def walk_clip(sk: Skeleton, frames: int, fps: float, amplitude: float, seed: int,
              flags: int = 0, root_speed: float = 1.2) -> Clip:
    """A looping clip: the bind pose with a sinusoidal swing per bone at a
    random phase; with XZ_ROOT the root travels along -z at root_speed."""
    rng = np.random.default_rng(seed)
    b = len(sk.parent)
    pos = np.tile(sk.bind_pos[None], (frames, 1, 1)).astype(np.float32)
    if flags & XZ_ROOT:
        pos[:, 0, 2] -= np.arange(frames, dtype=np.float32) / fps * root_speed
    rot = np.zeros((frames, b, 4), np.float32)
    phase = rng.uniform(0, 2 * np.pi, b)
    axes = rng.normal(size=(b, 3)).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    amp = rng.uniform(0.2, 1.0, b) * amplitude
    for f in range(frames):
        ang = np.sin(2 * np.pi * f / (frames - 1) + phase) * amp
        rot[f] = q_mul(sk.bind_rot, q_axis_angle(axes, ang.astype(np.float32)))
    for f in range(1, frames):   # each frame on the hemisphere of the one before
        rot[f] = np.where(np.sum(rot[f] * rot[f - 1], axis=-1, keepdims=True) < 0, -rot[f], rot[f])
    return Clip(pos, q_normalize(rot), fps, flags)


def locomotion_clips(sk: Skeleton) -> List[Clip]:
    """idle, walk and run: the locomotion controller blends them by speed
    at the points 0, 1.5 and 4 m/s."""
    return [walk_clip(sk, 25, 24.0, 0.1, 11), walk_clip(sk, 31, 30.0, 0.4, 12, XZ_ROOT),
            walk_clip(sk, 21, 30.0, 0.7, 13, XZ_ROOT)]


LOCOMOTION_POINTS = (0.0, 1.5, 4.0)


# -- the scene --------------------------------------------------------------------

@dataclass
class Scene:
    capacity: int
    parent: np.ndarray = None                 # int32 [N] (-1: root or dead)
    pos: np.ndarray = None                    # f32 [N, 3] local transforms
    rot: np.ndarray = None
    scale: np.ndarray = None
    alive: np.ndarray = None
    count: int = 0
    mi: List[tuple] = field(default_factory=list)        # (entity, model id)
    mi_capacity: int = 0
    camera: tuple = None                                  # (entity, fov, near, far)
    lights: List[tuple] = field(default_factory=list)    # (entity, range)
    light_capacity: int = 256
    animables: List[tuple] = field(default_factory=list)  # (entity, clip, start time)
    animable_capacity: int = 0
    animators: List[tuple] = field(default_factory=list)  # (entity, speed)
    animator_capacity: int = 0
    controller_inputs: int = 8
    bodies: List[tuple] = field(default_factory=list)    # (entity, shape, radius, he, friction)
    body_capacity: int = 0
    emitter: tuple = None                                 # (entity, capacity)
    skeleton: Skeleton = None
    clips: List[Clip] = field(default_factory=list)

    def __post_init__(self):
        n = self.capacity
        self.parent = np.full(n, -1, np.int32)
        self.pos = np.zeros((n, 3), np.float32)
        self.rot = np.tile(IDENTITY, (n, 1))
        self.scale = np.ones((n, 3), np.float32)
        self.alive = np.zeros(n, bool)

    def entity(self, position=(0.0, 0.0, 0.0), rotation=IDENTITY, scale=(1.0, 1.0, 1.0)) -> int:
        e = self.count
        self.count += 1
        self.alive[e] = True
        self.pos[e] = np.asarray(position, np.float32)
        self.rot[e] = q_normalize(np.asarray(rotation, np.float32))
        self.scale[e] = np.asarray(scale, np.float32)
        return e

    def global_transform(self, e: int):
        chain = [e]
        while self.parent[chain[-1]] >= 0:
            chain.append(int(self.parent[chain[-1]]))
        p, r, s = self.pos[chain[-1]], self.rot[chain[-1]], self.scale[chain[-1]]
        for c in reversed(chain[:-1]):
            p = (p + q_rot(r, self.pos[c] * s)).astype(np.float32)
            r, s = q_mul(r, self.rot[c]), (s * self.scale[c]).astype(np.float32)
        return p, r, s

    def set_parent(self, child: int, parent: int) -> None:
        """Hang `child` from `parent`, keeping its global transform."""
        gp, gr, gs = self.global_transform(child)
        pp, pr, ps = self.global_transform(parent)
        inv = q_conj(pr)
        self.parent[child] = parent
        self.pos[child] = q_rot(inv, gp - pp) / ps
        self.rot[child] = q_mul(inv, gr)
        self.scale[child] = gs / ps

    def add_character(self, rng, n_anim: int, i: int, half: float) -> None:
        e = self.entity(position=(rng.uniform(-half, half), 0.0, rng.uniform(-half, half)),
                        rotation=q_axis_angle(np.array([0, 1, 0], np.float32),
                                              rng.uniform(0, 2 * np.pi)))
        self.mi.append((e, MODEL_ID["character"]))
        if i < n_anim:
            self.animators.append((e, np.float32(rng.uniform(0, 5))))
        else:
            self.animables.append((e, int(rng.integers(3)), np.float32(rng.uniform(0, 1))))


STORM = {"emit_per_second": 200000.0, "gravity": 9.8, "life": 6.0,
         "spawn_lo": (-50.0, 20.0, -50.0, -1.0, -1.0), "spawn_hi": (50.0, 40.0, 50.0, 1.0, 1.0),
         "scale0": 0.05, "scale_rate": 0.02, "color": (0.8, 0.8, 0.9, 1.0)}


def full_frame_world(num_entities: int = 10240, num_characters: int = 64, num_bodies: int = 64,
                     particle_capacity: int = 2048, seed: int = 0) -> Scene:
    """The flagship: a camera, a sun, the storm emitter, the characters (half
    locomotion animators, half animables on looping clips), falling boxes
    and spheres, then 64 point lights and static props in hierarchies of
    depth at most 4 until the world is full."""
    rng = np.random.default_rng(seed)
    half = max(num_characters // 2, 1)
    s = Scene(num_entities, mi_capacity=num_entities, animable_capacity=half,
              animator_capacity=half, body_capacity=num_bodies)
    s.skeleton = humanoid_skeleton()
    s.clips = locomotion_clips(s.skeleton)
    cam = s.entity(position=(0.0, 15.0, 80.0))
    s.camera = (cam, np.float32(np.radians(70.0)), np.float32(0.3), np.float32(600.0))
    s.entity()                                    # the sun: an environment, not simulated
    s.emitter = (s.entity(), particle_capacity)
    n_anim = num_characters // 2
    for i in range(num_characters):
        s.add_character(rng, n_anim, i, 60.0)
    for _ in range(num_bodies):
        e = s.entity(position=(rng.uniform(-20, 20), rng.uniform(2, 30), rng.uniform(-20, 20)))
        s.mi.append((e, MODEL_ID["cube"]))
        if rng.random() < 0.5:
            s.bodies.append((e, SHAPE_BOX, 0.5, (0.5, 0.5, 0.5), 0.6))
        else:
            s.bodies.append((e, SHAPE_SPHERE, 0.5, (0.5, 0.5, 0.5), 0.4))
    lights, props, level = 0, [], {}
    while s.count < num_entities:
        if lights < 64:
            e = s.entity(position=rng.uniform(-100, 100, 3).astype(np.float32))
            rng.uniform(0.2, 1.0, 3)                   # colour
            rng.uniform(1, 8)                          # intensity
            s.lights.append((e, np.float32(rng.uniform(5, 25))))
            lights += 1
            continue
        parent = -1
        if props and rng.random() < 0.3:
            cand = int(rng.choice(props[-256:]))
            if level.get(cand, 0) < 3:
                parent = cand
        pos = rng.uniform(-100, 100, 3).astype(np.float32)
        pos[1] = abs(pos[1]) * 0.1
        axis = rng.normal(size=3).astype(np.float32)
        axis /= np.linalg.norm(axis)
        e = s.entity(position=pos, rotation=q_axis_angle(axis, rng.uniform(0, np.pi)),
                     scale=np.full(3, rng.uniform(0.5, 2.0), np.float32))
        if parent >= 0:
            s.set_parent(e, parent)
            s.pos[e] = rng.uniform(-3, 3, 3).astype(np.float32)
        level[e] = level.get(parent, -1) + 1 if parent >= 0 else 0
        s.mi.append((e, int(rng.integers(3))))
        props.append(e)
    return s


def skinned_crowd_world(num_characters: int = 256, animator_fraction: float = 0.5,
                        seed: int = 0) -> Scene:
    """A camera and the characters: the first `animator_fraction` locomotion
    animators with root motion, the rest animables on looping clips."""
    rng = np.random.default_rng(seed)
    s = Scene(num_characters + 8, mi_capacity=num_characters + 8,
              animable_capacity=num_characters, animator_capacity=num_characters)
    s.skeleton = humanoid_skeleton()
    s.clips = locomotion_clips(s.skeleton)
    cam = s.entity(position=(0.0, 10.0, 60.0))
    s.camera = (cam, np.float32(np.radians(70.0)), np.float32(0.3), np.float32(500.0))
    n_anim = int(num_characters * animator_fraction)
    for i in range(num_characters):
        s.add_character(rng, n_anim, i, 50.0)
    return s


RECIPES: Dict[str, object] = {"full_frame_world": full_frame_world,
                              "skinned_crowd_world": skinned_crowd_world}


def build(config: dict, seed: int) -> Scene:
    """The configuration's scene: the recipe named by the last part of its
    ``builder``, called with its ``args`` and the seed."""
    return RECIPES[config["builder"].rsplit(".", 1)[-1]](**config["args"], seed=int(seed))
