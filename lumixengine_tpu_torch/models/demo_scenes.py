"""Procedural demo scenes (counterpart of ``lumixengine_tpu/models/demo_scenes.py``).

``full_frame_world`` is the flagship scene builder: transform hierarchy,
frustum culling, skinned characters (animables and locomotion animators with
root motion), rigid bodies and a particle emitter. It makes the same numpy
RNG draws in the same order as the reference, and keeps its capacities, so
one seed gives one scene and one state layout in both packages. The crowd,
1M-particle, script and headless builders are not ported.
"""
from __future__ import annotations

import numpy as np

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
