"""Procedural demo scenes (counterpart of ``lumixengine_tpu/models/demo_scenes.py``).

``full_frame_world`` is the flagship scene builder: transform hierarchy,
frustum culling, skinned characters (animables and locomotion animators with
root motion), rigid bodies and a particle emitter. ``headless_demo_world`` is
the headless demo tick (~2k props in a hierarchy of depth <= 4, a camera and
32 point lights). ``skinned_crowd_world`` and ``particle_stress_world`` are
the crowd and the 1M-particle stress; ``box_drop_pile`` is the 10k-box drop
on the slot pipeline (the scene the reference's ``bench.py --config boxes``
builds), and ``box_drop_world`` the same boxes as a rendered world on the
engine's step and the PhysicsModule's banded branch; ``hull_debris_world``
is convex-hull debris over a static mesh collider on that branch. ``script_stress_world``
is the scripts config: every entity runs a
Lua update() compiled to the device fast path, built through
``app.create_full_engine``. Each makes the same numpy RNG draws in the same
order as the reference, and keeps its capacities, so one seed gives one
scene and one state layout in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from lumixengine_tpu_torch.core import host_math as hm
from lumixengine_tpu_torch.engine.engine import Engine
from lumixengine_tpu_torch.renderer.model import Model, make_humanoid_skeleton
from lumixengine_tpu_torch.renderer.render_module import RendererSystem

PARTICLE_STRESS_SCRIPT = """
const G = 9.8;
emitter storm {
    material "/maps/particles/dust.mat"
    emit_per_second 200000
    max_particles %(cap)d
    out i_position : float3
    out i_color : float4
    out i_scale : float
    var pos : float3
    var vel : float3
    var t : float
    fn emit() {
        t = 0;
        pos.x = random(-50, 50);
        pos.y = random(20, 40);
        pos.z = random(-50, 50);
        vel.x = random(-1, 1);
        vel.y = 0;
        vel.z = random(-1, 1);
    }
    fn update() {
        t = t + time_delta;
        vel.y = vel.y - G * time_delta;
        pos = pos + vel * time_delta;
        if pos.y < 0 { kill(); }
        if t > 6 { kill(); }
    }
    fn output() {
        i_position = pos;
        i_scale = 0.05 + 0.02 * t;
        i_color = {0.8, 0.8, 0.9, 1};
    }
}
"""


def _add_demo_models(renderer: RendererSystem):
    """cube, rock, tree, character (32-bone skeleton) — the reference's ids."""
    renderer.add_model(Model(name="cube", bounding_radius=0.87, material_id=1))
    renderer.add_model(Model(name="rock", bounding_radius=1.5,
                             lod_distances=np.array([20.0, 60.0, 150.0, np.inf], np.float32),
                             material_id=2))
    renderer.add_model(Model(name="tree", bounding_radius=4.0,
                             lod_distances=np.array([40.0, 120.0, np.inf, np.inf], np.float32),
                             material_id=3))
    renderer.add_model(Model(name="character", bounding_radius=1.2, material_id=4,
                             skeleton=make_humanoid_skeleton(32, seed=7)))
    return renderer


def build_engine(with_animation: bool = False, **caps):
    """Engine + renderer (+ the animation system with the idle/walk/run clips
    and the `locomotion` controller). Returns (engine, renderer[, anim])."""
    engine = Engine()
    engine.module_capacities = caps
    renderer = RendererSystem(engine)
    _add_demo_models(renderer)
    engine.add_system(renderer)
    if not with_animation:
        return engine, renderer
    from lumixengine_tpu_torch.animation.animation import XZ_ROOT_TRANSLATION, make_walk_clip
    from lumixengine_tpu_torch.animation.controller import (AnimationNode, Blend1D, Controller,
                                                            Input)
    from lumixengine_tpu_torch.animation.module import AnimationSystem

    anim = AnimationSystem(engine, renderer=renderer)
    sk = renderer.models.get(renderer.models.get_id("character")).skeleton
    anim.add_clip(make_walk_clip(sk, "idle", frames=25, fps=24.0, amplitude=0.1, seed=11))
    anim.add_clip(make_walk_clip(sk, "walk", frames=31, fps=30.0, amplitude=0.4, seed=12,
                                 flags=XZ_ROOT_TRANSLATION))
    anim.add_clip(make_walk_clip(sk, "run", frames=21, fps=30.0, amplitude=0.7, seed=13,
                                 flags=XZ_ROOT_TRANSLATION))
    # locomotion: blend idle → walk → run by a "speed" input
    anim.add_controller(Controller(
        "locomotion", anim.bank_statics,
        Blend1D(Input(0), [(0.0, AnimationNode(0)), (1.5, AnimationNode(1)),
                           (4.0, AnimationNode(2))]),
        inputs=["speed"]))
    engine.add_system(anim)
    return engine, renderer, anim


def skinned_crowd_world(num_characters: int = 256, animator_fraction: float = 0.5,
                        seed: int = 0):
    """The skinned crowd (BASELINE.md config 2): half animables (looping
    clips), half animators (locomotion controller with root motion), and a
    camera. Returns (engine, world, renderer, anim)."""
    rng = np.random.default_rng(seed)
    engine, renderer, anim = build_engine(
        with_animation=True,
        model_instances=num_characters + 8,
        animables=num_characters,
        animators=num_characters,
    )
    world = engine.create_world(capacity=num_characters + 8)
    cam = world.create_entity(position=(0.0, 10.0, 60.0), name="camera")
    world.create_component(cam, "camera", fov=np.radians(70.0), near=0.3, far=500.0)
    n_animators = int(num_characters * animator_fraction)
    for i in range(num_characters):
        e = world.create_entity(
            position=(rng.uniform(-50, 50), 0.0, rng.uniform(-50, 50)),
            rotation=hm.quat_from_axis_angle(np.array([0, 1, 0], np.float32),
                                             rng.uniform(0, 2 * np.pi)),
        )
        world.create_component(e, "model_instance", model="character")
        if i < n_animators:
            world.create_component(e, "animator", controller="locomotion",
                                   inputs={"speed": float(rng.uniform(0.0, 5.0))})
        else:
            world.create_component(e, "animable",
                                   clip=["idle", "walk", "run"][int(rng.integers(3))],
                                   start_time=float(rng.uniform(0, 1)))
    return engine, world, renderer, anim


def particle_stress_world(capacity: int = 1_000_000):
    """The particle stress (BASELINE.md config 4): one `storm` emitter at
    `capacity`. Returns (engine, world, renderer)."""
    engine, renderer = build_engine(model_instances=8)
    renderer.add_particle_script("storm", PARTICLE_STRESS_SCRIPT % {"cap": capacity})
    world = engine.create_world(capacity=8)
    cam = world.create_entity(position=(0.0, 10.0, 80.0), name="camera")
    world.create_component(cam, "camera")
    e = world.create_entity(name="storm")
    world.create_component(e, "particle_emitter", script="storm")
    return engine, world, renderer


def box_lattice(num_bodies: int, seed: int = 0) -> np.ndarray:
    """The box drop's start positions [num_bodies, 3] float32: the first
    `num_bodies` cells of a cubic lattice at 1.1 m pitch (x-major), each
    jittered by 0-5 cm on every axis from numpy's generator seeded with
    `seed`, lifted 2 m."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(num_bodies ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return (grid[:num_bodies] * 1.1 + rng.uniform(0, 0.05, (num_bodies, 3))
            + [0.0, 2.0, 0.0]).astype(np.float32)


# the reference bench's published tier for the box drop (bench.py --config boxes)
BOX_DROP_TIER = dict(slots=28, window=40, iterations=6, position_iterations=2, warm_start=True,
                     over_relax=1.4, settle_damping=0.05, sleep_speed=0.15, sleep_frames=15,
                     wake_speed=0.3)


def box_drop_pile(num_bodies: int = 10_000, seed: int = 0, device="cuda", **tier):
    """The 10k-box drop (BASELINE.md config 3, the PhysX parity scene): unit
    boxes (half extent 0.5, mass 1, friction 0.6, no restitution) on the
    first `num_bodies` cells of a cubic lattice at 1.1 m pitch, jittered by
    0-5 cm, lifted 2 m, at rest; the slot pipeline at the published tier,
    or with `tier`'s options of ``make_slot_world_step`` in place of
    ``BOX_DROP_TIER``'s (the classic tier: n_sweeps, warm_start,
    mass_split, sleeping).

    Returns (step, state, consts): `state` = (pos, rot, vel, angvel, carry)
    on `device` (the card unless the caller asks for the CPU), `consts` = the
    body tables there; one frame is step(pos, rot, vel, angvel, dt, carry,
    consts)."""
    from lumixengine_tpu_torch.ops import physics_ops as P
    from lumixengine_tpu_torch.ops import physics_slots as PSL

    nb = num_bodies
    step = PSL.make_slot_world_step(
        np.full(nb, P.SHAPE_BOX, np.int32), np.full(nb, 0.5, np.float32),
        np.full((3, nb), 0.5, np.float32), np.ones(nb, bool), np.ones(nb, np.float32),
        np.full((3, nb), 1.0 / (1.0 / 12 * 2.0), np.float32), np.full(nb, 0.6, np.float32),
        np.zeros(nb, np.float32), **{**BOX_DROP_TIER, **tier})
    pos = box_lattice(nb, seed).T.copy()
    rot = np.zeros((4, nb), np.float32)
    rot[3] = 1.0
    zeros = np.zeros((3, nb), np.float32)
    state = tuple(torch.as_tensor(a, device=device) for a in (pos, rot, zeros, zeros)) + (
        step.init_carry(device),)
    return step, state, step.init_consts(device)


def box_drop_world(num_bodies: int = 10_000, capacity: int = 10_240, window: int = 40,
                   seed: int = 0):
    """The 10k-box drop as a rendered game world on the engine's own step:
    the boxes of `box_lattice` (unit boxes: half extent 0.5, mass 1,
    friction 0.6, no restitution, at rest), each an entity with a dynamic
    box ``rigid_actor`` and a ``model_instance`` "cube", and a camera that
    sees the lattice, in a world of `capacity` entity slots whose
    PhysicsModule has `capacity` actor slots and the ground plane. Above
    256 actor slots ``broadphase="auto"`` takes the banded branch, whose
    sweep window (``sap_neighbors``) is `window`. Returns (engine, world,
    renderer, physics_system)."""
    from lumixengine_tpu_torch.physics.module import PhysicsSystem

    engine, renderer = build_engine(model_instances=capacity, actors=capacity)
    phys = PhysicsSystem(engine)
    engine.add_system(phys)
    world = engine.create_world(capacity=capacity)
    # the camera 35 m in front of the lattice's near face, level with its middle
    span = 1.1 * (int(np.ceil(num_bodies ** (1 / 3))) - 1)
    cam = world.create_entity(position=(0.5 * span, 2.0 + 0.5 * span, span + 35.0),
                              name="camera")
    world.create_component(cam, "camera", fov=np.radians(70.0), near=0.3, far=300.0)
    for p in box_lattice(num_bodies, seed):
        e = world.create_entity(position=tuple(float(x) for x in p))
        world.create_component(e, "rigid_actor", motion="dynamic", shape="box",
                               half_extents=(0.5, 0.5, 0.5), mass=1.0, friction=0.6)
        world.create_component(e, "model_instance", model="cube")
    world.modules["physics"].sap_neighbors = window
    return engine, world, renderer, phys


HULL_DEBRIS_WINDOW = 24   # the debris level's sweep window (PERF.md: its certificate's readings)


def hull_debris_world(num_hulls: int = 10_000, capacity: int = 10_240,
                      window: int = HULL_DEBRIS_WINDOW, seed: int = 0):
    """Convex-hull debris over static level geometry as a rendered game
    world on the engine's own step: the hulls of
    `physics_scenes.banded_pile` (random 10-point hulls at most 0.9 m
    across, cooked, in stacks of five at 2 m pitch; the points drawn from
    numpy's generator seeded with `seed`, in hull order), each an entity
    with a dynamic convex ``rigid_actor`` (mass 1, friction 0.6) and a
    ``model_instance`` "hull" (bounding radius 0.78 m, a 0.9 m hull's
    half diagonal), over the 8 x 1 x 8 m slab as a ``mesh_collider`` (SDF
    at resolution 24) and the ground plane, with a camera that sees the
    whole pile, in a world of `capacity` entity slots whose PhysicsModule
    has `capacity` actor slots. Entity 0 is the camera, entity 1 the slab,
    entity 2 + i hull i (actor slot i, model instance i). Above 256 actor
    slots ``broadphase="auto"`` takes the banded branch, whose sweep window
    (``sap_neighbors``) is `window`. Returns (engine, world, renderer,
    physics_system)."""
    from lumixengine_tpu_torch.models.physics_scenes import (BOX_MESH_T, SLAB, banded_pile,
                                                             box_mesh)
    from lumixengine_tpu_torch.physics.module import PhysicsSystem

    engine, renderer = build_engine(model_instances=capacity, actors=capacity)
    renderer.add_model(Model(name="hull", bounding_radius=0.78, material_id=2))
    phys = PhysicsSystem(engine)
    engine.add_system(phys)
    world = engine.create_world(capacity=capacity)
    pile = banded_pile(num_hulls, seed)
    # level with the pile's top, 80 m beyond its near edge, looking along -z
    near = max(p[2] for p, _ in pile) + 80.0
    cam = world.create_entity(position=(0.0, 4.0, near), name="camera")
    world.create_component(cam, "camera", fov=np.radians(70.0), near=0.3, far=300.0)
    slab = world.create_entity(name="slab")
    world.create_component(slab, "mesh_collider", vertices=box_mesh(*SLAB), triangles=BOX_MESH_T,
                           resolution=24)
    for p, points in pile:
        e = world.create_entity(position=p)
        world.create_component(e, "rigid_actor", motion="dynamic", shape="convex", mass=1.0,
                               friction=0.6, points=points)
        world.create_component(e, "model_instance", model="hull")
    world.modules["physics"].sap_neighbors = window
    return engine, world, renderer, phys


def pile_bodies(state):
    """`state` (a WorldState with a physics module) with every world's rigid
    bodies moved into a tight pile: 4 x 4 to a layer at 0.95 m pitch, so that
    neighbours overlap by 5 cm and the pair stream carries contacts."""
    ph = state.modules["physics"]
    i = torch.arange(ph.pos.shape[-1], device=ph.pos.device)
    grid = torch.stack([(i % 4) * 0.95, 0.45 + (i // 16) * 0.95, ((i // 4) % 4) * 0.95])
    pos = grid.to(ph.pos.dtype).expand(ph.pos.shape).contiguous()
    return state.replace(modules={**state.modules, "physics": ph.replace(pos=pos)})


def full_frame_world(num_entities: int = 10240, num_characters: int = 64,
                     num_bodies: int = 64, particle_capacity: int = 2048, seed: int = 0):
    """The flagship scene: transform hierarchy + frustum culling + skinned
    characters + rigid bodies + particles, in one step, batched over worlds
    by the caller. Returns (engine, world, renderer, anim, physics_system)."""
    from lumixengine_tpu_torch.physics.module import PhysicsSystem

    rng = np.random.default_rng(seed)
    engine, renderer, anim = build_engine(
        with_animation=True,
        model_instances=num_entities,
        animables=max(num_characters // 2, 1),
        animators=max(num_characters // 2, 1),
        actors=num_bodies,
    )
    phys = PhysicsSystem(engine)
    engine.add_system(phys)
    renderer.add_particle_script("storm", PARTICLE_STRESS_SCRIPT % {"cap": particle_capacity})
    world = engine.create_world(capacity=num_entities)

    cam = world.create_entity(position=(0.0, 15.0, 80.0), name="camera")
    world.create_component(cam, "camera", fov=np.radians(70.0), near=0.3, far=600.0)
    env = world.create_entity(name="sun")
    world.create_component(env, "environment", color=(1.0, 0.95, 0.9), intensity=2.5)
    pe = world.create_entity(name="storm")
    world.create_component(pe, "particle_emitter", script="storm")

    # characters (half animators with locomotion + root motion, half animables)
    n_anim = num_characters // 2
    for i in range(num_characters):
        e = world.create_entity(
            position=(rng.uniform(-60, 60), 0.0, rng.uniform(-60, 60)),
            rotation=hm.quat_from_axis_angle(np.array([0, 1, 0], np.float32),
                                             rng.uniform(0, 2 * np.pi)),
        )
        world.create_component(e, "model_instance", model="character")
        if i < n_anim:
            world.create_component(e, "animator", controller="locomotion",
                                   inputs={"speed": float(rng.uniform(0, 5))})
        else:
            world.create_component(e, "animable",
                                   clip=["idle", "walk", "run"][int(rng.integers(3))],
                                   start_time=float(rng.uniform(0, 1)))

    # falling rigid bodies (boxes + spheres)
    for _ in range(num_bodies):
        e = world.create_entity(
            position=(rng.uniform(-20, 20), rng.uniform(2, 30), rng.uniform(-20, 20)))
        world.create_component(e, "model_instance", model="cube")
        if rng.random() < 0.5:
            world.create_component(e, "rigid_actor", motion="dynamic", shape="box",
                                   half_extents=(0.5, 0.5, 0.5), friction=0.6)
        else:
            world.create_component(e, "rigid_actor", motion="dynamic", shape="sphere",
                                   radius=0.5, friction=0.4)

    # the rest: static scenery with hierarchy (≤ depth 4) + lights
    n_lights = 64
    lights = 0
    model_names = ["cube", "rock", "tree"]
    props = []
    prop_level = {}
    while world.entity_count < num_entities:
        if lights < n_lights:
            e = world.create_entity(position=rng.uniform(-100, 100, 3).astype(np.float32))
            world.create_component(e, "point_light", color=rng.uniform(0.2, 1.0, 3),
                                   intensity=rng.uniform(1, 8), range=rng.uniform(5, 25))
            lights += 1
            continue
        parent = -1
        if props and rng.random() < 0.3:
            cand = int(rng.choice(props[-256:]))
            if prop_level.get(cand, 0) < 3:
                parent = cand
        pos = rng.uniform(-100, 100, 3).astype(np.float32)
        pos[1] = abs(pos[1]) * 0.1
        axis = rng.normal(size=3).astype(np.float32)
        axis /= np.linalg.norm(axis)
        e = world.create_entity(
            position=pos,
            rotation=hm.quat_from_axis_angle(axis, rng.uniform(0, np.pi)),
            scale=np.full(3, rng.uniform(0.5, 2.0), np.float32),
        )
        if parent >= 0:
            world.set_parent(e, parent)
            world.set_local_transform(e, position=rng.uniform(-3, 3, 3).astype(np.float32))
        prop_level[e] = prop_level.get(parent, -1) + 1 if parent >= 0 else 0
        world.create_component(e, "model_instance", model=model_names[int(rng.integers(3))])
        props.append(e)
    return engine, world, renderer, anim, phys


def headless_demo_world(num_entities: int = 2048, seed: int = 0, engine: Engine | None = None,
                        hierarchy_fraction: float = 0.35, instance_fraction: float = 0.9):
    """The headless demo tick (BASELINE.md config 1): scattered props, some
    parented (depth <= 4), one camera, an environment and up to 32 point
    lights. Returns (engine, world, renderer_system)."""
    rng = np.random.default_rng(seed)
    if engine is None:
        engine, renderer = build_engine(model_instances=num_entities)
    else:
        renderer = engine.system_manager.get_system("renderer_system")
    world = engine.create_world(capacity=num_entities)

    cam = world.create_entity(position=(0.0, 5.0, 40.0), name="camera")
    world.create_component(cam, "camera", fov=np.radians(70.0), near=0.3, far=500.0)
    env = world.create_entity(name="sun")
    world.create_component(env, "environment", color=(1.0, 0.96, 0.9), intensity=3.0)

    for _ in range(min(32, num_entities // 16)):
        e = world.create_entity(position=rng.uniform(-80, 80, 3).astype(np.float32))
        world.create_component(e, "point_light", color=rng.uniform(0.2, 1.0, 3),
                               intensity=rng.uniform(1, 8), range=rng.uniform(5, 25))

    model_names = ["cube", "rock", "tree"]
    props = []
    prop_level = {}
    for _ in range(num_entities - world.entity_count):
        parent = -1
        if props and rng.random() < hierarchy_fraction:
            cand = int(rng.choice(props[-256:]))
            if prop_level.get(cand, 0) < 3:   # hierarchy depth <= 4
                parent = cand
        pos = rng.uniform(-100, 100, 3).astype(np.float32)
        pos[1] = abs(pos[1]) * 0.1
        axis = rng.normal(size=3).astype(np.float32)
        axis /= np.linalg.norm(axis)
        e = world.create_entity(
            position=pos,
            rotation=hm.quat_from_axis_angle(axis, rng.uniform(0, np.pi)),
            scale=np.full(3, rng.uniform(0.5, 2.0), np.float32),
        )
        if parent >= 0:
            world.set_parent(e, parent)
            world.set_local_transform(e, position=rng.uniform(-3, 3, 3).astype(np.float32))
        prop_level[e] = prop_level.get(parent, -1) + 1 if parent >= 0 else 0
        if rng.random() < instance_fraction:
            world.create_component(e, "model_instance", model=model_names[int(rng.integers(3))])
        props.append(e)
    return engine, world, renderer


SCRIPT_MOVER_LUA = """
local pos = {}
local t = 0
local speed = %(speed)f

function start()
    pos = this.position
end

function update(time_delta)
    t = t + time_delta * speed
    this.position = {
        pos[1] + math.cos(t) * 3,
        pos[2] + math.abs(math.sin(t * 0.7)),
        pos[3] + math.sin(t) * 3
    }
end
"""


def script_stress_world(num_scripts: int = 64, device="cuda"):
    """The scripts config (bench.py --config scripts): every entity runs a
    real Lua update() (the demo's move.lua kinematics pattern), compiled to
    the device fast path (script/lua_fastpath.py) once the game starts.
    Seven speeds (i % 7) make seven groups. Returns (engine, world, renderer)."""
    from lumixengine_tpu_torch import app as app_mod

    engine = app_mod.create_full_engine(device=device, model_instances=num_scripts + 2)
    rsys = engine.system_manager.get_system("renderer_system")
    mid = rsys.add_model(Model(name="mover_ball", bounding_radius=0.5))
    world = engine.create_world(capacity=num_scripts + 8)
    cam = world.create_entity(position=(0.0, 10.0, 60.0), name="camera")
    world.create_component(cam, "camera")
    sm = world.modules["script"]
    rng = np.random.default_rng(3)
    for i in range(num_scripts):
        e = world.create_entity(position=tuple(rng.uniform(-30, 30, 3).astype(float)),
                                name=f"mover{i}")
        world.create_component(e, "model_instance", model=mid)
        sm.attach_lua_script(e, source=SCRIPT_MOVER_LUA % {"speed": 0.5 + 0.1 * (i % 7)})
    return engine, world, world.modules["renderer"]


# -- the layered crowd: every animation component and controller node ----------------

LAYERED_INPUTS = ("dir_x", "dir_y", "gesture", "which", "tx", "ty", "tz")
IK_REACH_ATOL = 0.05     # tests/test_animation_ext.py: the effector at a reachable target
PROPERTY_ATOL = 1e-6
LAYERED_LIGHTS = 8
ARM_LAYER_WEIGHT = 20.0


def anim_api():
    """The classes and functions the layered crowd is built with (the
    port's); the CPU tests pass the JAX package's in their place."""
    from types import SimpleNamespace

    from lumixengine_tpu_torch.animation import animation, controller
    from lumixengine_tpu_torch.animation.module import AnimationSystem
    from lumixengine_tpu_torch.renderer.model import Model as M

    return SimpleNamespace(Engine=Engine, RendererSystem=RendererSystem, Model=M,
                           make_humanoid_skeleton=make_humanoid_skeleton,
                           AnimationSystem=AnimationSystem, make_walk_clip=animation.make_walk_clip,
                           nodes=controller)


def arm_chain(skeleton, length: int = 4) -> list:
    """The chain of `length` bones, root → effector, whose longest bone is
    the least share of its length (the first such): a chain that folds to
    reach targets near its root."""
    parent = skeleton.bone_parent
    abs_pos, _ = skeleton.absolute_bind()
    best = None
    for end in range(skeleton.bone_count):
        chain = [end]
        while len(chain) < length and parent[chain[0]] >= 0:
            chain.insert(0, int(parent[chain[0]]))
        if len(chain) < length:
            continue
        lengths = np.linalg.norm(np.diff(abs_pos[chain], axis=0), axis=1)
        share = float(lengths.max() / lengths.sum())
        if best is None or share < best[0]:
            best = (share, chain)
    return best[1]


def layered_controller(api, anim, skeleton, chain):
    """The layered crowd's controller: Layers over a Blend2D base of the four
    walk clips; an upper-body layer (bones at depth 2 and below) switching
    between a Select of two gesture clips and a rest clip; an arm layer
    (the chain's bones and their ancestors, weighted ARM_LAYER_WEIGHT
    against the layers' 1.8 so that the chain sits near its bind pose) of
    an IKNode on `chain` toward the (tx, ty, tz) inputs."""
    n = api.nodes
    b = anim.max_bones
    depth = np.zeros(skeleton.bone_count, np.int32)
    for i, p in enumerate(skeleton.bone_parent):
        depth[i] = 0 if p < 0 else depth[p] + 1
    upper = np.zeros(b, bool)
    upper[:skeleton.bone_count] = depth >= 2
    arm = np.zeros(b, bool)
    arm[chain] = True
    p = int(skeleton.bone_parent[chain[0]])
    while p >= 0:                       # and the chain root's ancestors
        arm[p] = True
        p = int(skeleton.bone_parent[p])
    ik = n.IKNode(n.AnimationNode(7), chain=list(chain), target_inputs=(4, 5, 6), alpha=1.0)
    root = n.Layers([
        (n.Blend2D(n.Input(0), n.Input(1), [((0.0, 1.0), n.AnimationNode(0)),
                                            ((1.0, 0.0), n.AnimationNode(1)),
                                            ((-1.0, 0.0), n.AnimationNode(2)),
                                            ((0.0, -1.0), n.AnimationNode(3))]), None, 1.0),
        (n.Switch(n.Input(2), n.Select(n.Input(3), [n.AnimationNode(4), n.AnimationNode(5)],
                                       blend_length=0.2),
                  n.AnimationNode(6), blend_length=0.3), upper, 0.8),
        (ik, arm, ARM_LAYER_WEIGHT)])
    return n.Controller("layered", anim.bank_statics, root, inputs=list(LAYERED_INPUTS))


def layered_crowd_world(num_characters: int = 128, seed: int = 0, api=None):
    """The layered crowd: `num_characters` characters with the crowd's
    32-bone humanoid skeleton, each an animator of layered_controller with
    its own inputs (a unit walk direction, the gesture switch and select, an
    arm target 0.1 to 0.2 of the chain's reach from the effector's bind
    position: FABRIK's 5 passes converge from there), a camera, LAYERED_LIGHTS point lights whose intensity (and, on
    every other one, range) follow property animators, and a platform whose
    local x and y follow one. Returns (engine, world, handles): the arm
    chain, the light and platform entities and each curve as numpy."""
    api = api or anim_api()
    rng = np.random.default_rng(seed)
    engine = api.Engine()
    engine.module_capacities = dict(model_instances=num_characters + 8, animables=8,
                                    animators=num_characters, point_lights=LAYERED_LIGHTS)
    renderer = api.RendererSystem(engine)
    sk = api.make_humanoid_skeleton(32, seed=7)
    renderer.add_model(api.Model(name="character", bounding_radius=1.2, material_id=4,
                                 skeleton=sk))
    engine.add_system(renderer)
    anim = api.AnimationSystem(engine, renderer=renderer)
    for i, name in enumerate(("n", "e", "w", "s", "wave_a", "wave_b", "rest", "arm")):
        anim.add_clip(api.make_walk_clip(sk, name, frames=15 + 2 * i, amplitude=0.0 if i == 7
                                         else 0.3, seed=20 + i))
    chain = arm_chain(sk)
    anim.add_controller(layered_controller(api, anim, sk, chain))
    engine.add_system(anim)
    world = engine.create_world(capacity=num_characters + LAYERED_LIGHTS + 8)
    cam = world.create_entity(position=(0.0, 10.0, 60.0), name="camera")
    world.create_component(cam, "camera", fov=np.radians(70.0), near=0.3, far=500.0)
    abs_pos, _abs_rot = sk.absolute_bind()
    lengths = np.linalg.norm(np.diff(abs_pos[chain], axis=0), axis=1)
    reach = float(lengths.sum())
    # a target nearer the root than this, the longest bone less the others, is out of reach
    inner = float(max(0.0, 2 * lengths.max() - reach))
    for _ in range(num_characters):
        e = world.create_entity(
            position=(rng.uniform(-50, 50), 0.0, rng.uniform(-50, 50)),
            rotation=hm.quat_from_axis_angle(np.array([0, 1, 0], np.float32),
                                             rng.uniform(0, 2 * np.pi)))
        world.create_component(e, "model_instance", model="character")
        ang = rng.uniform(0, 2 * np.pi)
        d = rng.normal(size=3)
        target = abs_pos[chain[-1]] + d / np.linalg.norm(d) * rng.uniform(0.1, 0.2) * reach
        world.create_component(e, "animator", controller="layered", inputs={
            "dir_x": float(np.cos(ang)), "dir_y": float(np.sin(ang)),
            "gesture": float(rng.integers(2)), "which": float(rng.integers(2)),
            "tx": float(target[0]), "ty": float(target[1]), "tz": float(target[2])})
    curves = {}
    lights = []
    for i in range(LAYERED_LIGHTS):
        e = world.create_entity(position=(rng.uniform(-40, 40), 4.0, rng.uniform(-40, 40)))
        world.create_component(e, "point_light", intensity=1.0, range=10.0)
        cs = [{"component": "point_light", "property": "intensity",
               "times": [0.0, 0.5 + 0.1 * i, 2.0], "values": [0.0, 5.0 + i, 1.0]}]
        if i % 2:
            cs.append({"component": "point_light", "property": "range",
                       "times": [0.0, 1.5], "values": [8.0, 12.0 + i]})
        world.create_component(e, "property_animator", curves=cs)
        curves[e] = cs
        lights.append(e)
    platform = world.create_entity(position=(0.0, 1.0, 0.0))
    cs = [{"component": "transform", "property": "x", "times": [0.0, 1.0, 2.0],
           "values": [-3.0, 3.0, -3.0]},
          {"component": "transform", "property": "y", "times": [0.0, 0.5, 1.0],
           "values": [1.0, 2.5, 1.0]}]
    world.create_component(platform, "property_animator", curves=cs)
    curves[platform] = cs
    return engine, world, {"chain": chain, "reach": reach, "inner": inner, "lights": lights,
                           "platform": platform, "curves": curves}


def ik_gaps(world, state, handles):
    """Each animator's effector against its target in model space, over the
    world batch: (distance [..., A], reachable [..., A]: the target lies in
    the chain's annulus, inner + 2 cm to reach − 2 cm from the chain's root
    as posed)."""
    import torch

    am = world.modules["animation"]
    slots = [k for k in range(am.animators.capacity) if am.animators.entity[k] >= 0]
    ms = state.modules["animation"]
    cols = torch.as_tensor([am.pool_col_animator(k) for k in slots], device=ms.pose_pos.device)
    pose = ms.pose_pos.index_select(-1, cols)
    target = ms.ctrl_inputs[..., 4:7, :].index_select(-1, cols - am.pool_col_animator(0))
    chain = handles["chain"]
    dist = torch.linalg.vector_norm(pose[..., :, chain[-1], :] - target, dim=-2)
    r = torch.linalg.vector_norm(target - pose[..., :, chain[0], :], dim=-2)
    reachable = (r >= handles["inner"] + 0.02) & (r <= handles["reach"] - 0.02)
    return dist.cpu().numpy(), reachable.cpu().numpy()


def property_rows(world, state, time: float, handles):
    """The animated rows of the layered crowd after a frame whose update
    read the world's time `time`, beside np.interp of each curve there:
    [(row name, the rows over the world batch, the expected value)]."""
    rm = world.modules["renderer"]
    rs = state.modules["renderer"]
    fields = {"intensity": "pl_intensity", "range": "pl_range"}
    out = []
    for e, curves in handles["curves"].items():
        for cur in curves:
            times = np.asarray(cur["times"], np.float32)
            t = np.float32(time) % np.float32(max(float(times[-1]), 1e-6))
            want = np.interp(t, times, np.asarray(cur["values"], np.float32))
            if cur["component"] == "transform":
                axis = "xyz".index(cur["property"])
                rows = state.local.pos[..., axis, world.slot(e)]
            else:
                rows = getattr(rs, fields[cur["property"]])[..., rm.point_lights.slot_of(e)]
            out.append((f"{e}.{cur['property']}", rows.detach().cpu().numpy(), want))
    return out
