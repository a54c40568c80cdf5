"""World blobs, prefabs and checkpoints between the JAX package and the port
(engine/serialize.py of each), on the CPU: the 8 cases of
tests/test_serialize.py, each with the writing and the reading package
crossed (JAX → port, port → JAX, port → port). A world loaded from a blob
must equal the world that wrote it: entity arrays, names, every module's
component records (``serialize_components``/``dump_stores``) and module
section (``serialize``), and the device state, field for field and bit for
bit. A checkpoint restores every leaf bit for bit and resumes. Also the
component records of each module that holds stores, equal key for key and
value for value between the packages on one scene, and the resource hub."""
import importlib
import struct
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu_torch import bridge
from test_torch_bridge import ref_to_numpy

torch.set_num_threads(2)

PKG = {"jax": "lumixengine_tpu", "torch": "lumixengine_tpu_torch"}
DIRECTIONS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]
DT = 1.0 / 60.0


def mod(pkg, name):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


def small_world(pkg):
    """tests/test_serialize.py's build_small: the skinned crowd of 8."""
    engine, world, _renderer, _anim = mod(pkg, "models.demo_scenes").skinned_crowd_world(
        num_characters=8)
    return engine, world


def physics_world(pkg):
    """tests/test_physics.py's build_world (8 actor slots) with the two
    bodies and the distance joint of test_physics_world_roundtrip."""
    engine = mod(pkg, "engine.engine").Engine()
    engine.module_capacities = {"actors": 8}
    engine.add_system(mod(pkg, "physics.module").PhysicsSystem(engine))
    world = engine.create_world(capacity=10)
    a = world.create_entity(position=(0.0, 5.0, 0.0))
    b = world.create_entity(position=(0.0, 3.0, 0.0))
    world.create_component(a, "rigid_actor", motion="static", shape="sphere", radius=0.1)
    world.create_component(b, "rigid_actor", motion="dynamic", shape="box",
                           half_extents=(0.4, 0.3, 0.2), mass=2.5, friction=0.7)
    j = world.create_entity()
    world.create_component(j, "distance_joint", body_a=a, body_b=b, length=2.0)
    engine.system_manager.get_system("physics_system").set_layers_collide(1, 2, False)
    return engine, world


def device_state(pkg, world):
    return world.device_state() if pkg == "jax" else world.device_state("cpu")


def to_numpy(pkg, state):
    return ref_to_numpy(state) if pkg == "jax" else bridge.state_to_numpy(state)


def components(pkg, module):
    return mod(pkg, "engine.serialize")._dump_module_components(module)


def assert_worlds_equal(wpkg, w1, rpkg, w2):
    """Host arrays, names, partitions, each module's records and section,
    and the device state, equal."""
    for name in ("alive", "parent", "local_pos", "local_rot", "local_scale", "partition_of"):
        np.testing.assert_array_equal(getattr(w2, name), getattr(w1, name), err_msg=name)
    assert w2.names == w1.names and w2.partitions == w1.partitions
    assert list(w2.modules) == list(w1.modules)
    for mname, m1 in w1.modules.items():
        m2 = w2.modules[mname]
        assert components(rpkg, m2) == components(wpkg, m1), mname
        assert m2.serialize() == m1.serialize(), mname
    got, ref = to_numpy(rpkg, device_state(rpkg, w2)), to_numpy(wpkg, device_state(wpkg, w1))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def step_once(pkg, engine, world):
    if pkg == "jax":
        step = engine.build_step(world, donate=False)
        return step(world.device_state(), jnp.float32(DT))
    return engine.build_step(world, "cpu")(world.device_state("cpu"), DT)


# -- the 8 cases of tests/test_serialize.py, writer → reader ---------------------------


def case_native_lz4_roundtrip(w, r, tmp_path):
    data = b"hello world, hello world, hello TPU! " * 100 + np.random.default_rng(0).bytes(512)
    comp = mod(w, "utils.native").lz4_compress(data)
    assert len(comp) < len(data)
    assert mod(r, "utils.native").lz4_decompress(comp, len(data)) == data
    assert mod(r, "utils.native").lz4_compress(data) == comp


def case_native_lz4_incompressible_and_empty(w, r, tmp_path):
    rnd = np.random.default_rng(1).bytes(10000)
    wn, rn = mod(w, "utils.native"), mod(r, "utils.native")
    assert rn.lz4_decompress(wn.lz4_compress(rnd), len(rnd)) == rnd
    assert rn.lz4_decompress(wn.lz4_compress(b""), 0) == b""


def case_world_roundtrip_preserves_everything(w, r, tmp_path):
    _we, world = small_world(w)
    blob = mod(w, "engine.serialize").serialize_world(world)
    assert blob[10:14] == b"lz4n"
    engine2, _ = small_world(r)
    world2 = mod(r, "engine.serialize").load_world(engine2, blob)
    assert world2.entity_count == world.entity_count
    assert_worlds_equal(w, world, r, world2)
    am1, am2 = world.modules["animation"], world2.modules["animation"]
    assert len(am1.animators) == len(am2.animators) > 0
    out = step_once(r, engine2, world2)
    assert int(np.asarray(out.frame)) == 1


def case_physics_world_roundtrip(w, r, tmp_path):
    _we, world = physics_world(w)
    blob = mod(w, "engine.serialize").serialize_world(world)
    engine2 = mod(r, "engine.engine").Engine()
    engine2.module_capacities = {"actors": 8}
    psys = mod(r, "physics.module").PhysicsSystem(engine2)
    engine2.add_system(psys)
    world2 = mod(r, "engine.serialize").load_world(engine2, blob)
    pm2 = world2.modules["physics"]
    b = 1
    assert pm2.actors.get(b, "mass") == np.float32(2.5)
    np.testing.assert_allclose(pm2.actors.get(b, "half_extents"), [0.4, 0.3, 0.2])
    assert len(pm2.statics().joint_a) == 1
    assert not psys.layer_matrix[1, 2] and not psys.layer_matrix[2, 1]
    assert_worlds_equal(w, world, r, world2)


def case_prefab_instantiate_with_remap(w, r, tmp_path):
    _we, world = small_world(w)
    root = world.create_entity(position=(1.0, 2.0, 3.0), name="prefab_root")
    c1 = world.create_entity(position=(1.5, 2.0, 3.0))
    c2 = world.create_entity(position=(1.0, 2.5, 3.0))
    world.set_parent(c1, root)
    world.set_parent(c2, root)
    world.create_component(c1, "model_instance", model="cube")
    prefab = mod(w, "engine.serialize").make_prefab(world, [root])
    _re, world2 = small_world(r)
    before = world2.entity_count
    created = mod(r, "engine.serialize").instantiate_prefab(world2, prefab,
                                                            position=(10.0, 0.0, 0.0))
    assert world2.entity_count == before + 3
    roots = [e for e in created if world2.get_parent(e) == -1]
    assert len(roots) == 1
    kids = world2.children_of(roots[0])
    assert len(kids) == 2 and world2.get_entity_name(roots[0]) == "prefab_root"
    np.testing.assert_allclose(world2.get_global_transform(roots[0])[0], [10.0, 0.0, 0.0],
                               atol=1e-5)
    offsets = sorted(round(float(world2.get_global_transform(k)[0][0] - 10.0), 3) for k in kids)
    assert offsets == [0.0, 0.5]
    rm2 = world2.modules["renderer"].model_instances
    assert [k for k in kids if k in rm2] == [k for k in kids
                                             if world2.get_global_transform(k)[0][0] > 10.25]


def case_version_gate(w, r, tmp_path):
    _we, world = small_world(w)
    blob = bytearray(mod(w, "engine.serialize").serialize_world(world))
    struct.pack_into("<I", blob, 6, 999)
    with pytest.raises(ValueError):
        mod(r, "engine.serialize")._parse(bytes(blob))


def case_not_a_blob(w, r, tmp_path):
    _re, world = small_world(r)
    with pytest.raises(ValueError):
        mod(r, "engine.serialize").deserialize_into(world, b"garbage")
    with pytest.raises(ValueError):
        mod(r, "engine.serialize").load_checkpoint(__file__, device_state(r, world))


def case_device_state_checkpoint_roundtrip(w, r, tmp_path):
    we, world = small_world(w)
    state = step_once(w, we, world)
    path = str(tmp_path / "sim.ckpt")
    mod(w, "engine.serialize").save_checkpoint(state, path)
    re_, world2 = small_world(r)
    restored = mod(r, "engine.serialize").load_checkpoint(path, device_state(r, world2))
    got, ref = to_numpy(r, restored), to_numpy(w, state)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert int(np.asarray(restored.frame)) == 1
    if r == "jax":
        out = re_.build_step(world2, donate=False)(restored, jnp.float32(DT))
    else:
        out = re_.build_step(world2, "cpu")(restored, DT)
    assert int(np.asarray(out.frame)) == 2


CASES = {f.__name__[5:]: f for f in (
    case_native_lz4_roundtrip, case_native_lz4_incompressible_and_empty,
    case_world_roundtrip_preserves_everything, case_physics_world_roundtrip,
    case_prefab_instantiate_with_remap, case_version_gate, case_not_a_blob,
    case_device_state_checkpoint_roundtrip)}


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=[f"{a}-to-{b}" for a, b in DIRECTIONS])
@pytest.mark.parametrize("case", list(CASES))
def test_serialize_case(case, writer, reader, tmp_path):
    CASES[case](writer, reader, tmp_path)


def test_checkpoint_of_a_world_batch_both_ways(tmp_path):
    """A [W=3] batch: the port's checkpoint in the JAX package's leaf order
    (it loads there) and back."""
    from lumixengine_tpu.engine import serialize as rser
    from lumixengine_tpu.parallel.mesh import replicate_state
    from lumixengine_tpu_torch.engine import serialize as pser

    _re, rworld = small_world("jax")
    rstate = replicate_state(rworld.device_state(), 3, jax.random.PRNGKey(5))
    pstate = bridge.state_from_numpy(ref_to_numpy(rstate), "cpu")
    pser.save_checkpoint(pstate, str(tmp_path / "p.ckpt"))
    back = rser.load_checkpoint(str(tmp_path / "p.ckpt"), rstate)
    rser.save_checkpoint(rstate, str(tmp_path / "r.ckpt"))
    again = pser.load_checkpoint(str(tmp_path / "r.ckpt"), pstate)
    ref = ref_to_numpy(rstate)
    for got in (ref_to_numpy(back), bridge.state_to_numpy(again)):
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the leaf order is the reference's tree_flatten order
    names = list(bridge.state_to_numpy(pstate, sort_keys=True))
    assert names == list(ref_to_numpy(rstate))


def test_component_records_equal_the_reference():
    """serialize_components / dump_stores of the renderer, physics and
    animation modules on one host world built by both packages: equal key
    for key and value for value (the blob's contract)."""
    def build(pkg):
        from_app = mod(pkg, "app").create_full_engine
        engine = from_app(model_instances=16) if pkg == "jax" else from_app(
            device="cpu", model_instances=16)
        world = engine.create_world(capacity=32)
        cam = world.create_entity(position=(0, 2, 10), name="cam")
        world.create_component(cam, "camera", fov=0.9)
        light = world.create_entity(position=(1, 3, 0))
        world.create_component(light, "point_light", intensity=3.0, range=7.0)
        env = world.create_entity()
        world.create_component(env, "environment", color=(0.5, 0.6, 0.7), intensity=2.0)
        d = world.create_entity(position=(0, 0, -3))
        world.create_component(d, "decal", half_extents=(1.0, 2.0, 3.0))
        b = world.create_entity(position=(0, 4, 0))
        world.create_component(b, "rigid_actor", motion="dynamic", shape="sphere", radius=0.3)
        s = world.create_entity(position=(2, 4, 0))
        world.create_component(s, "rigid_actor", motion="static", shape="box",
                               half_extents=(1.0, 0.5, 1.0))
        world.create_component(s, "instanced_cube", half_extents=(0.5, 0.5, 0.5), layer=1)
        c = world.create_entity(position=(0, 1, 4))
        world.create_component(c, "physics_controller", radius=0.4, height=1.6)
        return world

    rworld, pworld = build("jax"), build("torch")
    for name in ("renderer", "physics", "animation", "core", "navigation", "gui", "audio"):
        assert components("torch", pworld.modules[name]) == components(
            "jax", rworld.modules[name]), name
        assert pworld.modules[name].serialize() == rworld.modules[name].serialize(), name
        assert getattr(pworld.modules[name], "COMPONENT_STORES", {}) == getattr(
            rworld.modules[name], "COMPONENT_STORES", {}), name


def test_resource_hub_and_asset_cache(tmp_path):
    """The resource state machine through the port's file system, against
    the JAX package's on the same files."""
    (tmp_path / "a.txt").write_bytes(b"alpha")
    out = {}
    for pkg in ("jax", "torch"):
        fs = mod(pkg, "engine.file_system").FileSystem(str(tmp_path))
        res_mod = mod(pkg, "engine.resource")
        hub = res_mod.ResourceManagerHub(fs)
        ok, missing = hub.load("text", "a.txt"), hub.load("text", "missing.txt")
        again = hub.load("text", "a.txt")
        for _ in range(500):
            fs.process_callbacks()
            if ok.state != res_mod.EMPTY and missing.state != res_mod.EMPTY:
                break
            time.sleep(0.01)
        cache = res_mod.AssetCache()
        bakes = [cache.get_or_bake(b, lambda b=b: b.upper()) for b in (b"x", b"y", b"x")]
        out[pkg] = (ok.state, ok.data, missing.state, again is ok, ok.refcount, bakes,
                    cache.hits, cache.misses)
        hub.managers["text"].unload(ok)
        assert ok.refcount == 1
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 1 and out["torch"][2] == 2


PREFAB_SCRIPT = """
spawned = []
def start():
    spawned.extend(instantiate_prefab(PREFAB, position=(5.0, 0.0, -2.0)))
"""


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_script_instantiate_prefab_matches_reference(writer):
    """A Python inline script's instantiate_prefab (≙ the engine's
    instantiatePrefab from script code), the prefab written by either
    package: the spawned roots, their transforms and components equal the
    JAX package's."""
    _we, wworld = small_world(writer)
    root = wworld.create_entity(position=(1.0, 2.0, 3.0), name="crate")
    kid = wworld.create_entity(position=(1.0, 3.0, 3.0))
    wworld.set_parent(kid, root)
    wworld.create_component(kid, "model_instance", model="cube")
    prefab = mod(writer, "engine.serialize").make_prefab(wworld, [root])
    worlds = {}
    for pkg in ("jax", "torch"):
        engine, _ = small_world(pkg)
        engine.add_system(mod(pkg, "script.module").ScriptSystem(engine))
        world = engine.create_world(capacity=64)
        holder = world.create_entity(name="spawner")
        world.create_component(holder, "inline_script", source=PREFAB_SCRIPT)
        env = world.modules["script"].scripts[holder][0]
        env.globals["PREFAB"] = prefab
        engine.start_game(world)
        spawned = [h.id for h in env.globals["spawned"]]    # every created entity
        assert len(spawned) == 2 and [world.get_parent(e) for e in spawned].count(-1) == 1
        worlds[pkg] = world
    rw, pw = worlds["jax"], worlds["torch"]
    assert_worlds_equal("jax", rw, "torch", pw)
    e = pw.find_by_name("crate")
    np.testing.assert_allclose(pw.get_global_transform(e)[0], [5.0, 0.0, -2.0], atol=1e-6)
    assert len(pw.children_of(e)) == 1
