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
