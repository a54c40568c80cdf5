"""PhysicsModule scenes: the worlds of the committed golden trajectories
(``tests/data/golden_*.npz``, made by ``tools/golden_oracle.py``, a float64
sequential-impulse simulator) with the bounds the JAX package's
``tests/test_golden_trajectories.py`` holds its pipeline to, and a block of
boxes on the bench's grid for the banded branch.

A golden world is built as the reference's test builds it (``build_world``
of ``tests/test_parity.py``): actor capacity max(n, 2), 8 joint slots, the
golden's gravity, ground plane and damping, a body of mass 0 made static,
the joints from the golden's arrays, then the initial velocities written
into the state. Everything is made on `device`, the card unless the caller
asks for the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from lumixengine_tpu_torch.engine.engine import Engine
from lumixengine_tpu_torch.physics.module import PhysicsSystem

GOLDEN_NAMES = ("ballistic", "tumbling", "bounce", "stack3", "drop27", "friction_slide",
                "capsule_stack", "hinge_pendulum", "d6_slider")
# the body whose position is recorded every step (index into the golden's bodies)
GOLDEN_RECORD = {"ballistic": 0, "bounce": 0, "friction_slide": 0, "hinge_pendulum": 3,
                 "d6_slider": 1}
DT = 1.0 / 60.0
# The capsule bridge rests on an unstable equilibrium, and float32 rounding
# decides whether the top capsule stays or tips off, in the JAX package as in
# the port. It is held as an ensemble: CAPSULE_WORLDS starts, world 0 the
# golden's, the others with N(0, CAPSULE_EPS²) m/s on the top capsule's
# velocity. The JAX package with the solve K2 ports keeps
# CAPSULE_REFERENCE_PASSES of them within the golden's bounds (measured by
# tests/test_torch_golden.py on the CPU); the port must keep at least that
# count less CAPSULE_PASS_MARGIN, two standard errors of the difference of
# two such counts at an even rate (2 * sqrt(2 * 64 * 0.25)).
CAPSULE_WORLDS, CAPSULE_EPS = 64, 1e-6
CAPSULE_REFERENCE_PASSES, CAPSULE_PASS_MARGIN = 34, 11
_JOINTS = {0: "distance_joint", 1: "spherical_joint", 2: "hinge_joint", 3: "d6_joint"}


def physics_world(actors: int, gravity=(0.0, -9.81, 0.0), ground: bool = True,
                  damping=(0.05, 0.05), joints: int = 8):
    """(engine, world, physics system) with only the physics system, as the
    reference's physics tests build it."""
    engine = Engine()
    engine.module_capacities = {"actors": actors, "joints": joints}
    phys = PhysicsSystem(engine, gravity=gravity)
    phys.ground_plane = ground
    phys.linear_damping, phys.angular_damping = damping
    engine.add_system(phys)
    return engine, engine.create_world(capacity=actors + 8), phys


def golden_world(g, device="cuda"):
    """The world of golden `g` (the npz's arrays by name). Returns (engine,
    world, state on `device`, actor slot of each golden body)."""
    n = len(g["init_radius"])
    engine, world, _phys = physics_world(
        max(n, 2), gravity=tuple(float(x) for x in g["gravity"]), ground=bool(int(g["ground"])),
        damping=(float(g["lin_damping"]), float(g["ang_damping"])))
    pm = world.modules["physics"]
    masses = np.asarray(g["init_mass"]) if "init_mass" in g else np.ones(n)
    slots, ents = [], []
    for i in range(n):
        e = world.create_entity(position=tuple(float(x) for x in g["init_pos"][i]),
                                rotation=tuple(float(x) for x in g["init_rot"][i]))
        kw = dict(motion="dynamic" if masses[i] > 0 else "static", mass=float(max(masses[i], 1.0)),
                  friction=float(g["init_friction"][i]),
                  restitution=float(g["init_restitution"][i]))
        shape = int(g["init_shape"][i])
        he = tuple(float(x) for x in g["init_he"][i])
        if shape == 0:
            world.create_component(e, "rigid_actor", shape="sphere",
                                   radius=float(g["init_radius"][i]), **kw)
        elif shape == 2:
            world.create_component(e, "rigid_actor", shape="capsule",
                                   radius=float(g["init_radius"][i]), half_extents=he, **kw)
        else:
            world.create_component(e, "rigid_actor", shape="box", half_extents=he, **kw)
        slots.append(pm.actors.slot_of(e))
        ents.append(e)
    for j in range(len(g["joint_type"]) if "joint_type" in g else 0):
        jt = int(g["joint_type"][j])
        kwj = dict(body_a=ents[int(g["joint_a"][j])], body_b=ents[int(g["joint_b"][j])],
                   anchor_a=tuple(float(x) for x in g["joint_anchor_a"][j]),
                   anchor_b=tuple(float(x) for x in g["joint_anchor_b"][j]),
                   axis=tuple(float(x) for x in g["joint_axis"][j]),
                   length=float(g["joint_length"][j]))
        if int(g["joint_limit_on"][j]):
            kwj["limit"] = tuple(float(x) for x in g["joint_limit"][j])
        if jt == 3:
            kwj["linear_motion"] = tuple(int(x) for x in g["joint_lin_mask"][j])
            kwj["angular_motion"] = (1, 1, 1)   # the oracle locks every angular axis
        world.create_component(ents[int(g["joint_b"][j])], _JOINTS[jt], **kwj)
    state = world.device_state(device)
    ms = state.modules["physics"]
    vel, ang = ms.vel.clone(), ms.angvel.clone()
    cols = torch.as_tensor(slots, device=vel.device)
    vel[:, cols] = torch.as_tensor(np.asarray(g["init_vel"], np.float32).T, device=vel.device)
    ang[:, cols] = torch.as_tensor(np.asarray(g["init_ang"], np.float32).T, device=vel.device)
    state = state.replace(modules={**state.modules, "physics": ms.replace(vel=vel, angvel=ang)})
    return engine, world, state, slots


def golden_ensemble(g, worlds: int, eps: float, device="cuda", seed: int = 0):
    """Golden `g`'s world tiled to `worlds` worlds; world 0 starts as the
    golden does, each other one with N(0, eps²) m/s added to each dynamic
    body's initial velocity, drawn with numpy from `seed` (the same starts on
    every device). Returns (engine, world, batched state, slots)."""
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    engine, world, state, slots = golden_world(g, device)
    state = replicate_state(state, worlds)
    ms = state.modules["physics"]
    noise = np.random.default_rng(seed).standard_normal(ms.vel.shape).astype(np.float32) * eps
    noise[0] = 0.0
    noise *= world.modules["physics"].statics().dyn_mask
    vel = ms.vel + torch.as_tensor(noise, device=ms.vel.device)
    state = state.replace(modules={**state.modules, "physics": ms.replace(vel=vel)})
    return engine, world, state, slots


def golden_passes(name: str, g, pos: np.ndarray, vel: np.ndarray, slots):
    """Per world of a batch [W, 3, NB]: True where the final state holds the
    bounds of check_golden (for goldens bounded without a trajectory)."""
    out = []
    for p, v in zip(pos, vel):
        try:
            check_golden(name, g, None, p, v, slots)
            out.append(True)
        except AssertionError:
            out.append(False)
    return np.asarray(out)


def run_recorded(step, state, slot, steps: int):
    """`steps` frames of `step`; returns (state, positions of body `slot`
    after each frame [steps, ..., 3])."""
    traj = []
    for _ in range(steps):
        state = step(state, DT)
        traj.append(state.modules["physics"].pos[..., :, slot])
    return state, torch.stack(traj)


def check_golden(name: str, g, traj: np.ndarray, pos: np.ndarray, vel: np.ndarray, slots):
    """Hold one world's run of golden `name` to the bounds of the JAX
    package's tests/test_golden_trajectories.py. `traj` [steps, 3] is the
    recorded body's positions (None where the golden records none), `pos`
    and `vel` the final physics state [3, NB]. Returns the readings; raises
    AssertionError on the first bound broken."""
    out = {}

    def bound(key, value, limit, below=True):
        out[key] = float(value)
        if not (value < limit if below else value > limit):
            raise AssertionError(f"golden {name}: {key} = {value} (bound {limit})")

    body = None if pos is None else pos[:, slots].T     # [N, 3]
    if name == "ballistic":
        gold = g["traj_pos"]
        err = np.abs(traj - gold)
        bound("err_300", err[:300].max(), 1e-3)
        bound("rel_err", (err / (1.0 + np.abs(gold))).max(), 1e-4)
    elif name == "tumbling":
        raise ValueError("tumbling is checked on the final rotation: use check_tumbling")
    elif name == "bounce":
        gold = g["traj_pos"]
        y_dev, y_gold = traj[:, 1], gold[:, 1]
        fi_d, fi_g = int(np.argmax(y_dev < 0.52)), int(np.argmax(y_gold < 0.52))
        out["impact_frame"] = (fi_d, fi_g)
        if not (fi_g > 0 and abs(fi_d - fi_g) <= 2):
            raise AssertionError(f"golden bounce: impact frames {fi_d} vs {fi_g}")
        bound("pre_impact_err", np.abs(traj[: fi_g - 2] - gold[: fi_g - 2]).max(), 1e-3)
        seg = slice(fi_g + 5, fi_g + 120)
        bound("rebound_peak_err", abs(y_dev[seg].max() - y_gold[seg].max()), 0.06)
        bound("rest_err", abs(y_dev[-1] - y_gold[-1]), 3e-3)
        bound("rest_drift", np.abs(np.diff(y_dev[-30:])).max(), 1e-4)
    elif name == "stack3":
        bound("settle_err", np.abs(body[:, 1] - g["final_pos"][:, 1]).max(), 6e-3)
        bound("max_speed", np.abs(vel).max(), 1e-3)
    elif name == "drop27":
        gold = g["final_pos"]
        bound("lowest", body[:, 1].min(), 0.5 - 0.010, below=False)
        bound("height_err", abs(body[:, 1].max() - gold[:, 1].max()), 0.55)
        for ax in (0, 2):
            bound(f"footprint_max_{ax}", abs(body[:, ax].max() - gold[:, ax].max()), 0.6)
            bound(f"footprint_min_{ax}", abs(body[:, ax].min() - gold[:, ax].min()), 0.6)
        bound("mean_err", np.linalg.norm(body - gold, axis=1).mean(), 0.30)
        bound("max_speed", np.abs(vel[:, slots]).max(), 0.05)
    elif name == "friction_slide":
        bound("traj_err", np.abs(traj - g["traj_pos"]).max(), 1e-3)
        bound("max_speed", np.abs(vel).max(), 1e-3)
        bound("stop_err", abs(float(body[0, 0]) - g["final_pos"][0][0]), 1e-3)
    elif name == "capsule_stack":
        out["statics_moved"] = float(np.abs(body[:2] - g["init_pos"][:2].astype(np.float32)).max())
        if out["statics_moved"] != 0.0:                 # bit for bit unmoved
            raise AssertionError(f"golden capsule_stack: statics moved {out['statics_moved']}")
        top = body[2]
        bound("rest_height_err", abs(top[1] - g["final_pos"][2][1]), 0.015)
        bound("top_x", abs(top[0]), 0.55)
        bound("top_z", abs(top[2]), 0.05)
        bound("max_speed", np.abs(vel).max(), 1e-3)
    elif name == "hinge_pendulum":
        bound("plane_err", np.abs(traj[:, 2]).max(), 1e-3)
        err_traj = np.abs(traj - g["traj_pos"])
        bound("traj_err_p50", np.percentile(err_traj, 50), 0.1)
        bound("traj_err_max", err_traj.max(), 0.4)
        bound("final_err", np.abs(body - g["final_pos"]).max(axis=1).max(), 0.2)
        for a, b in ((1, 2), (2, 3)):
            gap = np.linalg.norm(body[a] - body[b])
            bound(f"gap_{a}{b}", gap, 1.00)
            bound(f"gap_{a}{b}_min", gap, 0.80, below=False)
    elif name == "d6_slider":
        bound("traj_err", np.abs(traj - g["traj_pos"]).max(), 1e-3)
        bound("locked_y_err", np.abs(traj[:, 1] - 2.0).max(), 2e-3)
        bound("locked_z_err", np.abs(traj[:, 2]).max(), 1e-3)
    else:
        raise ValueError(f"no golden named {name!r}")
    return out


def check_tumbling(g, rot: np.ndarray, slot: int):
    """The tumbling golden's bound: the final orientation within 1e-3 of the
    golden's (either sign of the quaternion)."""
    q_dev, q_gold = rot[:, slot], g["traj_rot"][-1]
    d = min(np.abs(q_dev - q_gold).max(), np.abs(q_dev + q_gold).max())
    if not d < 1e-3:
        raise AssertionError(f"golden tumbling: final rotation off by {d} (bound 0.001)")
    return {"rot_err": float(d)}


def box_block(num_bodies: int, capacity: int, seed: int = 0, neighbors: int = 16):
    """Unit boxes (half extent 0.5, mass 1, friction 0.6, no restitution) on
    the first `num_bodies` cells of a cubic lattice at 1.1 m pitch, jittered
    by 0-5 cm and lifted 2 m (the reference bench's box grid), as dynamic
    actors of a PhysicsModule with `capacity` actor slots: above 256 slots
    `broadphase="auto"` picks the banded branch, whose sweep window is
    `neighbors` (the module's `sap_neighbors`, 16 by default). Returns
    (engine, world)."""
    rng = np.random.default_rng(seed)
    engine, world, _phys = physics_world(capacity, joints=1)
    world.modules["physics"].sap_neighbors = neighbors
    side = int(np.ceil(num_bodies ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = (grid[:num_bodies] * 1.1 + rng.uniform(0, 0.05, (num_bodies, 3))
           + [0.0, 2.0, 0.0]).astype(np.float32)
    for p in pos:
        e = world.create_entity(position=tuple(float(x) for x in p))
        world.create_component(e, "rigid_actor", motion="dynamic", shape="box",
                               half_extents=(0.5, 0.5, 0.5), mass=1.0, friction=0.6)
    return engine, world


# -- game content: hulls, SDF meshes, heightfields, instanced statics, CCD,
# vehicles, character controllers and the queries. Each builder takes `api`,
# the classes it builds with (Engine, PhysicsSystem, RendererSystem, Model;
# the port's by default): the CPU tests build the same scene with the JAX
# package's classes and compare the two.

CUBE_CLOUD = np.array([[sx, sy, sz] for sx in (-0.5, 0.5) for sy in (-0.5, 0.5)
                       for sz in (-0.5, 0.5)], np.float32)
TETRA = np.array([[0.0, 0.5, 0.0], [0.5, -0.5, 0.5], [-0.5, -0.5, 0.5], [0.0, -0.5, -0.5]],
                 np.float32)
# a closed box mesh: (sx, sy, sz) corners with this triangle list
BOX_MESH_T = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                       [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])


def box_mesh(x, y, z):
    """The 8 corners of the box spanning x, y, z (each a (lo, hi) pair), in
    BOX_MESH_T's order."""
    return np.array([[sx, sy, sz] for sx in x for sy in y for sz in z], np.float32)


def port_api():
    from lumixengine_tpu_torch.engine.engine import Engine
    from lumixengine_tpu_torch.renderer.model import Model
    from lumixengine_tpu_torch.renderer.render_module import RendererSystem

    return SimpleNamespace(Engine=Engine, PhysicsSystem=PhysicsSystem,
                           RendererSystem=RendererSystem, Model=Model)


@dataclass
class Scene:
    """A built game-content world: its engine and world, the actor slots by
    name, the start velocities to write (slot → (vx, vy, vz)), and the slots
    whose positions a run records every frame (`trace`)."""

    engine: object
    world: object
    slots: Dict[str, int] = field(default_factory=dict)
    velocities: Dict[int, tuple] = field(default_factory=dict)
    trace: List[int] = field(default_factory=list)
    ents: Dict[str, int] = field(default_factory=dict)


def _game_world(api, actors: int, ground: bool, renderer: bool, capacity: int,
                gravity=(0.0, -9.81, 0.0)):
    api = api or port_api()
    engine = api.Engine()
    engine.module_capacities = {"actors": actors, "joints": 4}
    if renderer:
        rs = api.RendererSystem(engine)
        rs.add_model(api.Model(name="physcube", bounding_radius=0.87, material_id=0,
                               vertex_positions=CUBE_CLOUD.copy()))
        engine.add_system(rs)
    phys = api.PhysicsSystem(engine, gravity=gravity)
    phys.ground_plane = ground
    engine.add_system(phys)
    return engine, engine.create_world(capacity=capacity), phys


def props_world(api=None, seed: int = 11) -> Scene:
    """The props farm's world: ten props vignettes 8 m apart along x on the
    ground plane, each a JAX-package test's scene (tests/test_physics_convex.py
    and tests/test_physics_ext.py): a convex cube on a static box; the tetra;
    a convex cube on a static convex cube; a sphere on a static convex cube;
    a sphere and a box on a 2 x 1 x 2 SDF box mesh; a CCD sphere and a free
    twin fired down at 150 m/s on a thin SDF slab 2 m up (4 x 0.2 x 4); two
    CCD spheres fired head-on at 30 m/s each; a ball on a row of 3
    instanced cubes 1 m up; a ball on 2 instanced hulls of the cube model at
    scale 2; and a heap of 4 random 10-point hulls, 3 boxes, 2 spheres and a
    capsule. 25 actors and 5 instanced statics; all-pairs branch."""
    engine, world, _phys = _game_world(api, 32, True, True, 64)
    pm = world.modules["physics"]
    sc = Scene(engine, world)

    def actor(name, pos, **props):
        e = world.create_entity(position=pos)
        world.create_component(e, "rigid_actor", **props)
        sc.ents[name] = e
        sc.slots[name] = pm.actors.slot_of(e)
        return sc.slots[name]

    actor("base_box", (0.0, 0.5, 0.0), motion="static", shape="box", half_extents=(1.0, 0.5, 1.0))
    actor("cube_on_box", (0.0, 2.5, 0.0), motion="dynamic", shape="convex", points=CUBE_CLOUD)
    actor("tetra", (8.0, 2.0, 0.0), motion="dynamic", shape="convex", points=TETRA)
    actor("static_hull", (16.0, 0.5, 0.0), motion="static", shape="convex", points=CUBE_CLOUD)
    actor("cube_on_hull", (16.05, 1.52, 0.0), motion="dynamic", shape="convex", points=CUBE_CLOUD)
    actor("static_hull2", (24.0, 0.5, 0.0), motion="static", shape="convex", points=CUBE_CLOUD)
    actor("sphere_on_hull", (24.0, 2.0, 0.0), motion="dynamic", shape="sphere", radius=0.3)
    mesh = world.create_entity(position=(32.0, 0.0, 0.0))
    world.create_component(mesh, "mesh_collider", vertices=box_mesh((-1, 1), (0, 1), (-1, 1)),
                           triangles=BOX_MESH_T, resolution=24)
    actor("sphere_on_mesh", (31.5, 3.0, 0.1), motion="dynamic", shape="sphere", radius=0.25)
    actor("box_on_mesh", (32.5, 3.0, 0.0), motion="dynamic", shape="box",
          half_extents=(0.3, 0.3, 0.3))
    slab = world.create_entity(position=(40.0, 2.0, 0.0))
    world.create_component(slab, "mesh_collider", vertices=box_mesh((-2, 2), (-0.1, 0.1), (-2, 2)),
                           triangles=BOX_MESH_T, resolution=24)
    for name, x, ccd in (("ccd_sphere", 39.0, True), ("free_sphere", 41.0, False)):
        s = actor(name, (x, 5.0, 0.0), motion="dynamic", shape="sphere", radius=0.2, ccd=ccd)
        sc.velocities[s] = (0.0, -150.0, 0.0)
    for name, x, vx in (("head_on_a", 45.0, 30.0), ("head_on_b", 51.0, -30.0)):
        s = actor(name, (x, 3.0, 0.0), motion="dynamic", shape="sphere", radius=0.25, ccd=True)
        sc.velocities[s] = (vx, 0.0, 0.0)
    row = world.create_entity(position=(56.0, 1.0, 0.0))
    world.create_component(row, "instanced_model", model="physcube", count=3,
                           positions=np.array([[-3.0, 0, 0], [0.0, 0, 0], [3.0, 0, 0]], np.float32))
    world.create_component(row, "instanced_cube", half_extents=(0.5, 0.5, 0.5))
    actor("ball_on_cubes", (56.0, 4.0, 0.0), motion="dynamic", shape="sphere", radius=0.5)
    hulls = world.create_entity(position=(64.0, 0.0, 0.0))
    world.create_component(hulls, "instanced_model", model="physcube", count=2,
                           positions=np.array([[0.0, 0, 0], [4.0, 0, 0]], np.float32),
                           scales=np.full((2, 3), 2.0, np.float32))
    world.create_component(hulls, "instanced_mesh", mesh="physcube")
    actor("ball_on_hulls", (64.0, 4.0, 0.0), motion="dynamic", shape="sphere", radius=0.5)
    rng = np.random.default_rng(seed)
    heap = ([dict(shape="convex", points=rng.uniform(-0.45, 0.45, (10, 3)).astype(np.float32))
             for _ in range(4)] + [dict(shape="box", half_extents=(0.3, 0.25, 0.35))] * 3
            + [dict(shape="sphere", radius=0.3)] * 2
            + [dict(shape="capsule", radius=0.2, half_extents=(0.2, 0.35, 0.2))])
    for i, props in enumerate(heap):
        actor(f"heap{i}", (72.0 + 0.3 * (i % 2), 1.0 + 0.9 * i, 0.2 * (i % 3)), motion="dynamic",
              friction=0.6, **props)
    sc.trace = [sc.slots[n] for n in ("ccd_sphere", "free_sphere", "head_on_a", "head_on_b")]
    return sc


PROPS_FRAMES = 300   # the JAX tests' settle time


def check_props(sc: Scene, pos: np.ndarray, vel: np.ndarray, trace: np.ndarray,
                resting: bool = True):
    """The props world's physical checks, the JAX tests' own bounds, on one
    world's final pos/vel [3, NB] and its trace [frames, 3, 4] of the CCD
    spheres and the head-on pair. Without `resting` (a world perturbed from
    the built start, where the JAX tests' resting heights do not apply: a
    hull tilted on a box or a hull creeps up and does not settle, in the JAX
    package too) only the CCD, finiteness and no-sinking checks. Returns the
    readings; raises AssertionError on the first broken one."""
    out = {}

    def y(name):
        return float(pos[1, sc.slots[name]])

    def within(key, value, lo, hi):
        out[key] = round(float(value), 5)
        if not lo < value < hi:
            raise AssertionError(f"props: {key} = {value}, bounds ({lo}, {hi})")

    if not np.isfinite(pos).all():
        raise AssertionError("props: non-finite positions")
    if resting:
        within("cube_on_box_y", y("cube_on_box"), 1.42, 1.56)
        within("tetra_y", y("tetra"), 0.35, 0.62)
        within("cube_on_hull_y", y("cube_on_hull"), 1.42, 1.56)
        within("sphere_on_hull_y", y("sphere_on_hull"), 1.22, 1.36)
        within("sphere_on_mesh_y", y("sphere_on_mesh"), 1.1, 1.42)
        within("sphere_on_mesh_vy", abs(float(vel[1, sc.slots["sphere_on_mesh"]])), -1.0, 0.1)
        within("box_on_mesh_y", y("box_on_mesh"), 1.15, 1.5)
        within("ball_on_cubes_y", y("ball_on_cubes"), 1.9, 2.1)
        within("ball_on_hulls_y", y("ball_on_hulls"), 1.35, 1.6)
    # the CCD sphere never passes the slab (its centre at y = 2); the free twin does
    within("ccd_sphere_lowest", trace[:, 1, 0].min(), 1.5, 10.0)
    within("free_sphere_end", trace[-1, 1, 1], -10.0, 1.0)
    # the head-on CCD pair never crosses: a left of b in every frame
    within("head_on_gap_least", (trace[:, 0, 3] - trace[:, 0, 2]).min(), -1e-3, 10.0)
    heap = [sc.slots[n] for n in sc.slots if n.startswith("heap")]
    within("heap_lowest", pos[1, heap].min(), 0.0, 10.0)
    return out


def drive_world(api=None, seed: int = 5) -> Scene:
    """The drive farm's world on the ground plane: the four-wheel vehicle of
    tests/test_physics_ext.py (1200 kg, 800 N m, chassis 0.9 x 0.4 x 2.0 on
    layer 1, wheels of radius 0.35 on 60 kN/m springs), a character
    controller (radius 0.4, height 1.8) and twelve query targets on a ring
    of 25 m: 4 resting dynamic boxes, 4 resting dynamic spheres and 4 static
    hulls. drive_inputs says what the driver and the player do each frame;
    drive_rays where the 64 sensor rays point."""
    engine, world, _phys = _game_world(api, 16, True, False, 32)
    pm = world.modules["physics"]
    sc = Scene(engine, world)
    car = world.create_entity(position=(0.0, 0.8, 0.0), name="car")
    world.create_component(car, "vehicle", mass=1200.0, peak_torque=800.0,
                           chassis_half_extents=(0.9, 0.4, 2.0), chassis_layer=1)
    for x, z, slot in ((-0.8, 1.4, 0), (0.8, 1.4, 1), (-0.8, -1.4, 2), (0.8, -1.4, 3)):
        w = world.create_entity(position=(x, -0.45, z), parent=car)
        world.create_component(w, "wheel", slot=slot, radius=0.35, max_droop=0.2,
                               max_compression=0.2, spring_strength=60000.0,
                               spring_damper_rate=6000.0)
    sc.ents["car"], sc.slots["car"] = car, pm.actors.slot_of(car)
    player = world.create_entity(position=(6.0, 3.0, 0.0), name="player")
    world.create_component(player, "physics_controller", radius=0.4, height=1.8)
    sc.ents["player"] = player
    rng = np.random.default_rng(seed)
    for i in range(12):
        a = 2.0 * np.pi * (i + 0.5) / 12
        x, z = 25.0 * np.cos(a), 25.0 * np.sin(a)
        kind = ("box", "sphere", "hull")[i % 3]
        if kind == "box":
            props, y = dict(motion="dynamic", shape="box", half_extents=(0.5, 0.5, 0.5)), 0.5
        elif kind == "sphere":
            props, y = dict(motion="dynamic", shape="sphere", radius=0.6), 0.6
        else:
            cloud = (rng.uniform(-0.45, 0.45, (10, 3)) * 2.0).astype(np.float32)
            props, y = dict(motion="static", shape="convex", points=cloud), 1.0
        e = world.create_entity(position=(float(x), y, float(z)))
        world.create_component(e, "rigid_actor", **props)
        sc.slots[f"{kind}{i}"] = pm.actors.slot_of(e)
    sc.trace = [sc.slots["car"]]
    return sc


DRIVE_FRAMES = 240
DRIVE_RAYS = 64
DRIVE_LAYER_MASK = 1          # the targets' layer 0; the chassis is on layer 1
DRIVE_SWEEP_RADIUS = 0.3
PLAYER_STEP = (0.05, 0.0, 0.0)


def drive_inputs(frame: int):
    """(throttle, steer) before frame `frame`: at rest on the suspension
    for 30 frames, full throttle to frame 120, then 0.6 throttle steering
    0.4 rad."""
    if frame < 30:
        return 0.0, 0.0
    return (1.0, 0.0) if frame < 120 else (0.6, 0.4)


def drive_rays(seed: int = 5):
    """The sensor rays (offsets from the chassis centre [R, 3], unit
    directions [R, 3]): a horizontal fan all round at the chassis's height,
    the origins 2.5 m out, beyond the chassis."""
    rng = np.random.default_rng(seed)
    a = 2.0 * np.pi * (np.arange(DRIVE_RAYS) + rng.uniform(0, 1, DRIVE_RAYS)) / DRIVE_RAYS
    d = np.stack([np.cos(a), rng.uniform(-0.02, 0.02, DRIVE_RAYS), np.sin(a)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (2.5 * d * [1.0, 0.0, 1.0]).astype(np.float32), d.astype(np.float32)


def check_drive(sc: Scene, pos, angvel, trace, ctrl_pos, ctrl_grounded, player_world_x,
                hits: int):
    """The drive world's checks, from tests/test_physics_ext.py: the vehicle
    stands on its suspension, speeds forward under throttle and turns under
    steer; the controller is grounded, walked, and its entity follows it;
    the sensor rays hit targets. One world's final pos/angvel [3, NB],
    trace [frames, 3, 1] of the chassis, ctrl_pos [3, NC], ctrl_grounded
    [NC]. Returns the readings; raises AssertionError on a broken one."""
    out = {}

    def within(key, value, lo, hi):
        out[key] = round(float(value), 5)
        if not lo < value < hi:
            raise AssertionError(f"drive: {key} = {value}, bounds ({lo}, {hi})")

    car = trace[:, :, 0]
    within("chassis_y_at_rest", car[29, 1], 0.5, 1.2)
    within("forward_speed_at_120", (car[119, 2] - car[118, 2]) / DT, 1.0, 100.0)
    within("z_at_120", car[119, 2], 0.5, 1e3)
    within("yaw_rate_end", abs(float(angvel[1, sc.slots["car"]])), 0.05, 100.0)
    within("lateral_end", abs(float(car[-1, 0])), 0.3, 1e3)
    slot = 0     # the player is the first controller
    within("player_grounded", float(ctrl_grounded[slot]), 0.5, 1.5)
    within("player_y", abs(float(ctrl_pos[1, slot])), -1.0, 1e-3)
    within("player_x", float(ctrl_pos[0, slot]), 6.0 + 2.5, 1e3)
    within("player_entity_gap", abs(player_world_x - float(ctrl_pos[0, slot])), -1.0, 1e-4)
    within("ray_hits", hits, 0, 1 << 30)
    return out


def terrain_heights(seed: int = 3, n: int = 64) -> np.ndarray:
    """A seeded n x n heightmap of smooth hills between about 0.2 and 1.8 m."""
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0.0, 2.0 * np.pi, 4)
    z, x = np.mgrid[0:n, 0:n].astype(np.float64)
    h = (1.0 + 0.5 * np.sin(2 * np.pi * x / 32 + ph[0]) * np.cos(2 * np.pi * z / 24 + ph[1])
         + 0.25 * np.sin(2 * np.pi * (x + z) / 11 + ph[2]) + 0.05 * np.cos(2 * np.pi * z / 5 + ph[3]))
    return h.astype(np.float32)


TERRAIN_ORIGIN = (-32.0, 0.0, -32.0)


def terrain_world(api=None, seed: int = 3) -> Scene:
    """The terrain farm's world (tests/test_physics_ext.py's heightfield
    test is the template): a 64 x 64 seeded heightmap at 1 m cells as the
    heightfield in place of the ground plane, 4 spheres, 4 boxes and 4
    random 10-point hulls dropped on it from 3.5 m, and a character controller
    walking on it."""
    engine, world, _phys = _game_world(api, 16, False, True, 32)
    pm = world.modules["physics"]
    sc = Scene(engine, world)
    rs = engine.system_manager.get_system("renderer_system")
    tid = rs.terrains.add(terrain_heights(seed), xz_scale=1.0)
    hf = world.create_entity(position=TERRAIN_ORIGIN)
    world.create_component(hf, "heightfield", terrain=tid)
    rng = np.random.default_rng(seed)
    for i in range(12):
        x, z = -10.5 + 7.0 * (i % 4), -7.0 + 7.0 * (i // 4)
        kind = ("sphere", "box", "hull")[i // 4]
        props = {"sphere": dict(shape="sphere", radius=0.3),
                 "box": dict(shape="box", half_extents=(0.3, 0.3, 0.3)),
                 "hull": dict(shape="convex",
                              points=rng.uniform(-0.45, 0.45, (10, 3)).astype(np.float32))}[kind]
        e = world.create_entity(position=(x, 3.5, z))
        world.create_component(e, "rigid_actor", motion="dynamic", friction=0.8, **props)
        sc.slots[f"{kind}{i}"] = pm.actors.slot_of(e)
    walker = world.create_entity(position=(1.0, 4.0, 2.0), name="walker")
    world.create_component(walker, "physics_controller", radius=0.4, height=1.8)
    sc.ents["walker"] = walker
    return sc


TERRAIN_FRAMES = 300
WALKER_STEP = (0.03, 0.0, 0.02)


def terrain_height_at(x, z, seed: int = 3):
    """The terrain world's height at world x, z (numpy, the bilinear sample
    of renderer/terrain.sample_height on the host)."""
    h = terrain_heights(seed)
    n = h.shape[0]
    gx = np.clip(np.asarray(x, np.float32) - TERRAIN_ORIGIN[0], 0.0, n - 1.001)
    gz = np.clip(np.asarray(z, np.float32) - TERRAIN_ORIGIN[2], 0.0, n - 1.001)
    x0, z0 = np.floor(gx).astype(int), np.floor(gz).astype(int)
    fx, fz = gx - x0, gz - z0
    return ((h[z0, x0] * (1 - fx) + h[z0, x0 + 1] * fx) * (1 - fz)
            + (h[z0 + 1, x0] * (1 - fx) + h[z0 + 1, x0 + 1] * fx) * fz) + TERRAIN_ORIGIN[1]


def check_terrain(sc: Scene, pos, radius, ctrl_pos, ctrl_grounded, walker_world):
    """The terrain world's checks: every body rests on the heightfield (its
    centre above the terrain below it, a sphere's within 0.15 m of its
    radius, a box's of its half extent, a hull within its bounding radius,
    as the reference takes a hull on a heightfield), the walker is grounded
    on the terrain and its entity follows it. One world's pos [3, NB],
    radius [NB] (the actors' bounding radii), ctrl_pos [3, NC],
    ctrl_grounded [NC], walker_world [3]."""
    out = {}

    def within(key, value, lo, hi):
        out[key] = round(float(value), 5)
        if not lo < value < hi:
            raise AssertionError(f"terrain: {key} = {value}, bounds ({lo}, {hi})")

    if not np.isfinite(pos).all():
        raise AssertionError("terrain: non-finite positions")
    gap = {}
    for name, s in sc.slots.items():
        gap[name] = float(pos[1, s] - terrain_height_at(pos[0, s], pos[2, s]))
    sph = [g - 0.3 for n, g in gap.items() if n.startswith("sphere")]
    box = [g - 0.3 for n, g in gap.items() if n.startswith("box")]
    hull = [g - float(radius[sc.slots[n]]) for n, g in gap.items() if n.startswith("hull")]
    within("sphere_rest_err", max(map(abs, sph)), -1.0, 0.15)
    within("box_rest_least", min(box), -0.15, 1.0)
    within("box_rest_most", max(box), -1.0, 0.45)
    within("hull_rest_err", max(map(abs, hull)), -1.0, 0.15)
    within("walker_grounded", float(ctrl_grounded[0]), 0.5, 1.5)
    within("walker_on_terrain", abs(float(ctrl_pos[1, 0])
                                    - terrain_height_at(ctrl_pos[0, 0], ctrl_pos[2, 0])), -1.0, 1e-4)
    within("walker_entity_gap", float(np.abs(walker_world - ctrl_pos[:, 0]).max()), -1.0, 1e-4)
    return out


SLAB = ((-4.0, 4.0), (0.0, 1.0), (-4.0, 4.0))   # the banded level's SDF slab, x, y, z


def banded_props_level(api=None, hulls: int = 1024, capacity: int = 1024, seed: int = 7,
                       neighbors: int = 16, stack: int = 5, pitch: float = 2.0,
                       grid: bool = False) -> Scene:
    """The banded props level: `hulls` random 10-point hulls (at most 0.9 m
    across) over the 8 x 1 x 8 SDF slab of tests/test_physics_big.py and
    the ground plane, piled as tests/test_physics_convex.py's banded pile:
    stacks of `stack` hulls 0.85 m apart from 0.8 m above the surface, each
    hull offset as that test's (x ±0.125, z -0.2 to 0.24), the stacks on a
    square grid of an even side at `pitch` (at 2 m their centres lie on odd
    metres, and none straddles the slab's edge). With `grid`, the hulls lie
    instead in `stack` full layers 1 m apart from 2 m up, on a square grid
    at `pitch`. With `capacity` above 256 actor slots, `broadphase="auto"`
    picks the banded branch, whose sweep window is `neighbors`."""
    engine, world, _phys = _game_world(api, capacity, True, False, capacity + 8)
    pm = world.modules["physics"]
    pm.sap_neighbors = neighbors
    sc = Scene(engine, world)
    slab = world.create_entity()
    world.create_component(slab, "mesh_collider", vertices=box_mesh(*SLAB), triangles=BOX_MESH_T,
                           resolution=24)
    (x0, x1), (_y0, top), (z0, z1) = SLAB
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(np.ceil(hulls / stack))))
    side += side % 2
    for i in range(hulls):
        if grid:
            col, j = i % (side * side), i // (side * side)
        else:
            col, j = i // stack, i % stack
        x, z = pitch * (col % side - (side - 1) / 2), pitch * (col // side - (side - 1) / 2)
        if grid:
            p = (x, 2.0 + 1.0 * j, z)
        else:
            floor = top if x0 < x < x1 and z0 < z < z1 else 0.0
            p = (x + 0.25 * (j % 2) - 0.125, floor + 0.8 + 0.85 * j, z + 0.22 * (j // 2) - 0.2)
        e = world.create_entity(position=p)
        world.create_component(e, "rigid_actor", motion="dynamic", shape="convex", mass=1.0,
                               points=rng.uniform(-0.45, 0.45, (10, 3)).astype(np.float32))
        sc.slots[f"hull{i}"] = pm.actors.slot_of(e)
    return sc


BANDED_PROPS_STEPS = 360   # the JAX test's settle time
BANDED_PROPS_WINDOW = 24   # the level's sweep window (PERF.md: the narrowest that drops nothing)


SETTLED_SPEED, SETTLED_DEPTH = 0.8, 0.02   # tests/test_physics_convex.py's banded pile bounds


def hull_penetration(verts, valid):
    """Each hull's deepest vertex below the ground plane or inside the
    level's slab, in m (negative: the hull clears both): verts [3, V, N]
    world vertices, valid [V, N]. Returns [N]."""
    x, y, z = verts
    (x0, x1), (y0, y1), (z0, z1) = SLAB
    inside = (x > x0) & (x < x1) & (y > y0) & (y < y1) & (z > z0) & (z < z1)
    slab = np.minimum.reduce([x - x0, x1 - x, y - y0, y1 - y, z - z0, z1 - z])
    depth = np.where(inside, np.maximum(-y, slab), -y)
    return np.where(valid, depth, -np.inf).max(axis=0)


def check_banded_props(sc: Scene, pos, vel, penetration, unsettled_max: int = 0):
    """The JAX banded pile test's checks after settling, hull by hull:
    finite positions, every velocity component below SETTLED_SPEED, no
    vertex deeper than SETTLED_DEPTH in the ground or the slab
    (`penetration`, hull_penetration of each hull [N] in slot order). A
    hull that breaks a bound is unsettled; at most `unsettled_max` may be
    (the JAX test: none)."""
    slots = list(sc.slots.values())
    if not np.isfinite(pos).all():
        raise AssertionError("banded props: non-finite positions")
    speed = np.abs(vel[:, slots]).max(axis=0)
    fast, deep = ~(speed < SETTLED_SPEED), ~(penetration < SETTLED_DEPTH)
    out = {"max_speed": round(float(speed.max()), 5),
           "max_penetration": round(float(penetration.max()), 5),
           "fast": int(fast.sum()), "deep": int(deep.sum()), "unsettled": int((fast | deep).sum())}
    if out["unsettled"] > unsettled_max:
        raise AssertionError(f"banded props: {out}, at most {unsettled_max} unsettled")
    return out


def replicate_scene(state, worlds: int, seed: int):
    """The scene's state tiled to `worlds` worlds that diverge as
    parallel.mesh.replicate_state makes them (positions, velocities and
    sleep counters perturbed from a generator seeded `seed` on the state's
    device), except world 0, which starts as built: the JAX tests' bounds
    (check_props and the others) hold for that start."""
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    dev = state.local.pos.device
    batch = replicate_state(state, worlds, torch.Generator(device=dev).manual_seed(seed))
    ms, ms0 = batch.modules["physics"], state.modules["physics"]

    def first(t, t0):
        t = t.clone()
        t[0] = t0
        return t

    ms = ms.replace(vel=first(ms.vel, ms0.vel), angvel=first(ms.angvel, ms0.angvel),
                    sleep=first(ms.sleep, ms0.sleep))
    local = batch.local.replace(pos=first(batch.local.pos, state.local.pos))
    return batch.replace(local=local, modules={**batch.modules, "physics": ms})


def start_state(sc: Scene, device):
    """The scene's state on `device` with its start velocities written."""
    state = sc.world.device_state(device)
    if not sc.velocities:
        return state
    ms = state.modules["physics"]
    vel = ms.vel.clone()
    for slot, v in sc.velocities.items():
        vel[..., :, slot] = torch.as_tensor(v, dtype=torch.float32, device=vel.device)
    return state.replace(modules={**state.modules, "physics": ms.replace(vel=vel)})


def scene_inputs(kind: str, sc: Scene, state, frame: int):
    """What the host does before frame `frame` of scene `kind`: the drive
    world's driver inputs (when they change) and player step, the terrain
    world's walker step."""
    pm = sc.world.modules["physics"]
    if kind == "drive":
        if frame in (0, 30, 120):
            state = pm.set_vehicle_input(state, sc.ents["car"], *drive_inputs(frame))
        state = pm.move_controller(state, sc.ents["player"], PLAYER_STEP)
    elif kind == "terrain":
        state = pm.move_controller(state, sc.ents["walker"], WALKER_STEP)
    return state


def drive_queries(sc: Scene, state, offsets, dirs):
    """The drive world's sensor queries on `state`: DRIVE_RAYS rays and as
    many sphere sweeps (radius DRIVE_SWEEP_RADIUS) from around each world's
    chassis against the targets' layer. offsets, dirs: [R, 3] tensors on the
    state's device. Returns ((hit, t, idx) of the rays, of the sweeps), each
    [..., R]."""
    pm = sc.world.modules["physics"]
    ms = state.modules["physics"]
    origin = ms.pos[..., :, sc.slots["car"]].unsqueeze(-2) + offsets      # [..., R, 3]
    return (pm.raycast(ms, origin, dirs, layer_mask=DRIVE_LAYER_MASK),
            pm.sweep(ms, origin, dirs, DRIVE_SWEEP_RADIUS, layer_mask=DRIVE_LAYER_MASK))


CONTACT_TIE_ATOL = 1e-5   # a contact's depth at a tie, or at the active threshold
PH = "modules.physics."
# the fields two runs of a frame are held to (bridge.state_to_numpy names):
# within a position tolerance, within a velocity tolerance, or equal
POS_FIELDS = ("local.pos", "local.rot", "world.pos", "world.rot", PH + "pos", PH + "rot",
              PH + "ctrl_pos", PH + "ctrl_disp", PH + "ctrl_vel_y")
VEL_FIELDS = tuple(PH + f for f in ("vel", "angvel", "lam_n", "lam_t1", "lam_t2", "sap_lam",
                                    "sap_glam"))
EXACT_FIELDS = ("frame",) + tuple(PH + f for f in (
    "sleep", "pair_key", "sap_rank", "ctrl_grounded", "veh_throttle", "veh_steer",
    "counters.active_contacts", "counters.sap_window_miss", "counters.pruned_pair_miss"))
CALM_SPEED = (0.03, 0.05)   # physics_ops.update_sleep's thresholds, m/s and rad/s


def _contact_rows(c, device="cpu"):
    """(point, normal, depth, active) of Contacts or of such a tuple (torch
    or numpy, any device) as tensors on `device`."""
    rows = c[2:] if len(c) == 6 else c
    return [torch.as_tensor(np.array(x.detach().cpu() if isinstance(x, torch.Tensor) else x),
                            device=device) for x in rows]


def contact_ties(got, ref, atol: float = CONTACT_TIE_ATOL):
    """Where two contact sets of one frame (Contacts, or (point, normal,
    depth, active) tuples, on any devices) differ, each difference explained
    as a decision at a tie: an active flag whose depth lies within `atol` of
    0, or another vertex or axis of the same depth (within `atol`) picked by
    a top-k or an argmin, as when a hull rests face down on an equal face.
    Returns [(slot index, "active" or "tie", margin)]; raises AssertionError
    on a difference that is no tie, a depth more than `atol` apart on a slot
    active in both included."""
    gp, gn, gd, ga = _contact_rows(got)
    rp, rn, rd, ra = _contact_rows(ref)
    out = []
    for idx in torch.nonzero(ga != ra).tolist():
        i = tuple(idx)
        margin = float(max(abs(gd[i]), abs(rd[i])))
        if not margin <= atol:
            raise AssertionError(f"an active flag flipped away from the threshold at {i}: {margin}")
        out.append((i, "active", margin))
    both = ga & ra
    deeper = torch.nonzero(both & ~((gd - rd).abs() <= atol)).tolist()
    if deeper:
        i = tuple(deeper[0])
        raise AssertionError(f"a contact's depth differs at {i}: {float(gd[i])} vs {float(rd[i])}")
    gap = torch.maximum((gp - rp).abs().amax(dim=-2), (gn - rn).abs().amax(dim=-2))
    for idx in torch.nonzero(both & (gap > atol)).tolist():
        i = tuple(idx)
        out.append((i, "tie", float(abs(gd[i] - rd[i]))))
    return out


def contact_gap(got, ref) -> float:
    """The largest difference between two contact sets of one frame in
    point, normal or depth, over the slots active in either."""
    g, r = _contact_rows(got), _contact_rows(ref)
    act = g[3] | r[3]
    vec = torch.maximum((g[0] - r[0]).abs().amax(dim=-2), (g[1] - r[1]).abs().amax(dim=-2))
    return float(torch.where(act, torch.maximum(vec, (g[2] - r[2]).abs()), 0.0).max())


def step_on_contacts(pm, step, state, contacts, dt=DT):
    """`step` from `state` with the all-pairs or pruned contact set
    `contacts` ((point, normal, depth, active), any device) in place of the
    one the module builds: what a frame makes of another package's or
    device's contact decisions."""
    own = pm._contact_stage

    def stage(st, dt_):
        c = own(st, dt_)
        c.contacts = c.contacts._replace(**dict(zip(("point", "normal", "depth", "active"),
                                                    _contact_rows(contacts, c.contacts.point.device))))
        return c

    pm._contact_stage = stage
    try:
        return step(state, dt)
    finally:
        del pm._contact_stage


def state_gap(got, ref, pos_atol: float, vel_atol: float, sleep_flips: bool = False):
    """Two states of one frame (bridge.state_to_numpy dicts) against the
    tolerances: POS_FIELDS within `pos_atol`, VEL_FIELDS within `vel_atol`,
    EXACT_FIELDS equal. With `sleep_flips` a body's sleep counter may differ
    (two devices round a calm threshold apart): such a body is left out of
    the physics pos, rot, vel and angvel and must move slower than twice
    CALM_SPEED. Returns (largest abs difference of each float field, the
    first break as text or None, the bodies whose counters differ)."""
    woke = got[PH + "sleep"] != ref[PH + "sleep"]
    errs, broke = {}, None
    for k in POS_FIELDS + VEL_FIELDS:
        if not got[k].size:
            continue
        d = np.abs(got[k].astype(np.float64) - ref[k].astype(np.float64))
        if sleep_flips and k in (PH + "pos", PH + "rot", PH + "vel", PH + "angvel"):
            d = np.where(woke[..., None, :], 0.0, d)
        errs[k] = float(d.max())
        if broke is None and not errs[k] <= (pos_atol if k in POS_FIELDS else vel_atol):
            broke = f"{k} {errs[k]:.3g} at {np.unravel_index(np.argmax(d), d.shape)}"
    for k in EXACT_FIELDS:
        if broke is None and not (sleep_flips and k == PH + "sleep") \
                and not np.array_equal(got[k], ref[k]):
            broke = k
    if sleep_flips and woke.any() and broke is None:
        speed = np.maximum(*(np.linalg.norm(np.maximum(np.abs(got[PH + f]), np.abs(ref[PH + f])),
                                            axis=-2) / calm
                             for f, calm in zip(("vel", "angvel"), CALM_SPEED)))
        if not speed[woke].max() < 2.0:
            broke = f"sleep counters of bodies at {speed[woke].max():.3g} times the calm speed"
    return errs, broke, woke


def grid_rows(g):
    """Banded grids ([3, k, K, NB] points and normals, [k, K, NB] depths and
    flags) as contact rows: slots flattened to [3, S] and [S]."""
    return tuple(x.reshape(x.shape[0], -1) if x.dim() == 4 else x.reshape(-1) for x in g)


def step_on_banded_sat(step, start, ref_sat, dt=DT):
    """`step` from `start` with each banded polytope SAT
    (physics_banded.banded_polytope_grids, the banded branch's hull pairs)
    replaced by `ref_sat` on the same inputs, which returns another
    package's or device's grids on the inputs' device. Returns (state, the
    ties between the two grids of every call (contact_ties), their largest
    gap (contact_gap))."""
    from lumixengine_tpu_torch.ops import physics_banded as PBD

    own_sat, ties, gaps = PBD.banded_polytope_grids, [], [0.0]

    def swapped(*args):
        own, ref = own_sat(*args), ref_sat(*args)
        ties.extend(contact_ties(grid_rows(own), grid_rows(ref)))
        gaps.append(contact_gap(grid_rows(own), grid_rows(ref)))
        return ref

    PBD.banded_polytope_grids = swapped
    try:
        return step(start, dt), ties, max(gaps)
    finally:
        PBD.banded_polytope_grids = own_sat


def explain_break(step, start, ref, gap, drift: float, pm=None, ref_contacts=None,
                  ref_sat=None):
    """Why a frame breaks the tolerances: `start` is the reference's own
    state before the frame, on `step`'s device, `ref` the reference's next
    state (a bridge.state_to_numpy dict), and `gap(got, ref)` returns
    (errs, first break or None). If `step` from `start` holds, the two runs'
    drift before the frame (`drift`, within the tolerances) flipped a
    decision: ("drift", drift). Else the reference's contact decisions from
    `start` are put in place of the step's own: on the all-pairs and pruned
    branches `ref_contacts()` gives its contact set, on the banded branch
    `ref_sat` computes its polytope SAT grids (step_on_banded_sat). The two
    sets must differ only at ties (contact_ties) or, with no tie, by at most
    CONTACT_TIE_ATOL (contact_gap), and `step` on the reference's decisions
    must hold: ("tie", the largest tie's depth margin) or ("rounding", the
    gap). Returns (cause, margin, errs of the frame that holds); raises
    AssertionError when neither explains the break."""
    from lumixengine_tpu_torch import bridge

    errs, broke = gap(bridge.state_to_numpy(step(start, DT)), ref)
    if broke is None:
        return "drift", drift, errs
    if ref_sat is not None:
        state, ties, cgap = step_on_banded_sat(step, start, ref_sat)
    elif ref_contacts is not None:
        ref_c = ref_contacts()
        own_c = pm._contact_stage(start, DT).contacts
        ties, cgap = contact_ties(own_c, ref_c), contact_gap(own_c, ref_c)
        state = step_on_contacts(pm, step, start, ref_c)
    else:
        raise AssertionError(f"{broke} from the reference's own state")
    if not ties and not cgap <= CONTACT_TIE_ATOL:
        raise AssertionError(f"{broke} from the reference's own state; contacts {cgap:.3g} apart")
    errs, broke2 = gap(bridge.state_to_numpy(state), ref)
    if broke2 is not None:
        raise AssertionError(f"{broke}, then {broke2} on the reference's contact decisions")
    if ties:
        return "tie", max(m for *_i, m in ties), errs
    return "rounding", cgap, errs
