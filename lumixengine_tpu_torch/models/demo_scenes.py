"""Procedural demo scenes (counterpart of ``lumixengine_tpu/models/demo_scenes.py``).

``full_frame_world`` is the flagship scene builder. It makes the same numpy
RNG draws in the same order as the reference, so one seed gives one scene in
both packages. The ported slice runs it with its animation and particle arms
at zero (``num_characters=0, particle_capacity=0``); other values raise.
"""
from __future__ import annotations

import numpy as np

from lumixengine_tpu_torch.core import host_math as hm
from lumixengine_tpu_torch.engine.engine import Engine
from lumixengine_tpu_torch.renderer.model import Model
from lumixengine_tpu_torch.renderer.render_module import RendererSystem


def _add_demo_models(renderer: RendererSystem):
    """cube, rock, tree, character — the reference's ids (the character's
    skeleton belongs to the unported animation arm)."""
    renderer.add_model(Model(name="cube", bounding_radius=0.87, material_id=1))
    renderer.add_model(Model(name="rock", bounding_radius=1.5,
                             lod_distances=np.array([20.0, 60.0, 150.0, np.inf], np.float32),
                             material_id=2))
    renderer.add_model(Model(name="tree", bounding_radius=4.0,
                             lod_distances=np.array([40.0, 120.0, np.inf, np.inf], np.float32),
                             material_id=3))
    renderer.add_model(Model(name="character", bounding_radius=1.2, material_id=4))
    return renderer


def build_engine(with_animation: bool = False, **caps):
    if with_animation:
        raise NotImplementedError("the animation system is not ported")
    engine = Engine()
    engine.module_capacities = caps
    renderer = RendererSystem(engine)
    _add_demo_models(renderer)
    engine.add_system(renderer)
    return engine, renderer


def full_frame_world(num_entities: int = 10240, num_characters: int = 0,
                     num_bodies: int = 64, particle_capacity: int = 0, seed: int = 0):
    """The flagship scene: transform hierarchy + frustum culling + rigid
    bodies (+ skinned characters and particles in the reference, not ported).
    Returns (engine, world, renderer, physics_system)."""
    if num_characters > 0:
        raise NotImplementedError("skinned characters (animation) are not ported")
    if particle_capacity > 0:
        raise NotImplementedError("particle emitters are not ported")
    from lumixengine_tpu_torch.physics.module import PhysicsSystem

    rng = np.random.default_rng(seed)
    engine, renderer = build_engine(model_instances=num_entities, actors=num_bodies)
    phys = PhysicsSystem(engine)
    engine.add_system(phys)
    world = engine.create_world(capacity=num_entities)

    cam = world.create_entity(position=(0.0, 15.0, 80.0), name="camera")
    world.create_component(cam, "camera", fov=np.radians(70.0), near=0.3, far=600.0)
    env = world.create_entity(name="sun")
    world.create_component(env, "environment", color=(1.0, 0.95, 0.9), intensity=2.5)
    # the particle emitter's entity exists (its emitter is not ported)
    world.create_entity(name="storm")

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
    return engine, world, renderer, phys
