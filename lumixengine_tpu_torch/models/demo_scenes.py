"""Procedural demo scenes (counterpart of ``lumixengine_tpu/models/demo_scenes.py``).

``full_frame_world`` is the flagship scene builder: transform hierarchy,
frustum culling, skinned characters (animables and locomotion animators with
root motion), rigid bodies and a particle emitter. ``headless_demo_world`` is
the headless demo tick (~2k props in a hierarchy of depth <= 4, a camera and
32 point lights). ``skinned_crowd_world`` and ``particle_stress_world`` are
the crowd and the 1M-particle stress; ``box_drop_pile`` is the 10k-box drop
on the slot pipeline (the scene the reference's ``bench.py --config boxes``
builds). Each makes the same numpy RNG draws in the same order as the
reference, and keeps its capacities, so one seed gives one scene and one
state layout in both packages. ``script_stress_world`` is not ported.
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


# the reference bench's published tier for the box drop (bench.py --config boxes)
BOX_DROP_TIER = dict(slots=28, window=40, iterations=6, position_iterations=2, warm_start=True,
                     over_relax=1.4, settle_damping=0.05, sleep_speed=0.15, sleep_frames=15,
                     wake_speed=0.3)


def box_drop_pile(num_bodies: int = 10_000, seed: int = 0, device="cuda"):
    """The 10k-box drop (BASELINE.md config 3, the PhysX parity scene): unit
    boxes (half extent 0.5, mass 1, friction 0.6, no restitution) on the
    first `num_bodies` cells of a cubic lattice at 1.1 m pitch, jittered by
    0-5 cm, lifted 2 m, at rest; the slot pipeline at the published tier.

    Returns (step, state, consts): `state` = (pos, rot, vel, angvel, carry)
    on `device` (the card unless the caller asks for the CPU), `consts` = the
    body tables there; one frame is step(pos, rot, vel, angvel, dt, carry,
    consts)."""
    from lumixengine_tpu_torch.ops import physics_ops as P
    from lumixengine_tpu_torch.ops import physics_slots as PSL

    nb = num_bodies
    rng = np.random.default_rng(seed)
    step = PSL.make_slot_world_step(
        np.full(nb, P.SHAPE_BOX, np.int32), np.full(nb, 0.5, np.float32),
        np.full((3, nb), 0.5, np.float32), np.ones(nb, bool), np.ones(nb, np.float32),
        np.full((3, nb), 1.0 / (1.0 / 12 * 2.0), np.float32), np.full(nb, 0.6, np.float32),
        np.zeros(nb, np.float32), **BOX_DROP_TIER)
    side = int(np.ceil(nb ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)[:nb]
    pos = (grid * 1.1 + rng.uniform(0, 0.05, (nb, 3)) + [0.0, 2.0, 0.0]).T.astype(np.float32)
    rot = np.zeros((4, nb), np.float32)
    rot[3] = 1.0
    zeros = np.zeros((3, nb), np.float32)
    state = tuple(torch.as_tensor(a, device=device) for a in (pos, rot, zeros, zeros)) + (
        step.init_carry(device),)
    return step, state, step.init_consts(device)


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
