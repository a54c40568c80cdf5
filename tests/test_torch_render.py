"""The render config's device passes and the consumer side of a view in the
port against the JAX package, on the CPU: `pipeline.prepare_view` in both
sort modes, `_cull_instanced` and `draw_stream.record_frame`;
`shadows.shadow_pass` and `cascade_matrices`; `clusters.fill_clusters`
(the chunked bitset words against their dense oracle, the SWAR popcount
against `jax.lax.population_count`); bone attachments
(`RenderModule.late_update`); and the render frame: the flagship at test
size, 3 frames and both passes. The reference runs under `jax.vmap` where
the port takes the batch axis."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu.parallel.mesh import replicate_state as ref_replicate
from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.models import demo_scenes as pds
from lumixengine_tpu_torch.renderer import clusters as PC
from lumixengine_tpu_torch.renderer import pipeline as PP
from lumixengine_tpu_torch.renderer import shadows as PS
from test_torch_animation import FLAGSHIP_TEST
from test_torch_bridge import DT, ref_to_numpy, reference_step
from test_torch_step import (FRAMES, TRANSFORM_ATOL, R, assert_rest_equal, compare,
                             compare_arms)

torch.set_num_threads(1)

LIGHT_DIR = (0.3, -1.0, 0.2)   # bench.py --config render
GEOM_RTOL = 1e-5        # cascade splits, spheres, light positions, extents, matrices:
                        # relative to the field's largest magnitude (a centre's
                        # near-0 x sums corners hundreds of metres apart)
# the margins within which two float32 implementations may disagree are the port's:
# PS.SHADOW_MARGIN (casters), PC.CLUSTER_D2_EPS (cluster tests), PP.DEPTH_EPS (depth keys)
VIEW_FIELDS = ("visible", "lod", "sort_key", "sort_key_lo", "order", "instance_pos",
               "instance_rot", "instance_scale", "instance_model", "instance_slot",
               "visible_count", "lights_visible", "instanced_visible")


def _np(x):
    a = np.asarray(x)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


@functools.lru_cache(maxsize=None)
def demo_batch(num_worlds: int = 4, num_entities: int = 512):
    """The headless demo world replicated to `num_worlds` diverging worlds
    by the reference's replicate_state, one reference frame in: (reference
    world, reference state, port world, the same state in the port)."""
    from lumixengine_tpu.models import demo_scenes as rds

    rengine, rworld, _r = rds.headless_demo_world(num_entities)
    rstate = ref_replicate(rworld.device_state(), num_worlds, jax.random.PRNGKey(11))
    rstate = reference_step(rengine, rworld, batched=True)(rstate, jnp.float32(DT))
    _pe, pworld, _pr = pds.headless_demo_world(num_entities)
    return rworld, rstate, pworld, bridge.state_from_numpy(ref_to_numpy(rstate), "cpu")


def check_view(rv, pv, margins=None, depth=None):
    """The port's View against the reference's: equal; or, with `margins` =
    cull_margins and `depth` = depth_margins, the masks equal outside the
    cull/LOD margins, the keys equal wherever no decision and no depth
    rounding sits at a margin, and in every world whose keys all agree the
    same draw order and instance buffers (positions within
    TRANSFORM_ATOL). Returns the instances at a margin."""
    if margins is None:
        for f in VIEW_FIELDS:
            np.testing.assert_array_equal(getattr(pv, f).numpy(), _np(getattr(rv, f)), err_msg=f)
        return 0
    vis_m, lod_m, light_m = (m.numpy() for m in margins)
    moved = (pv.visible.numpy() != np.asarray(rv.visible))
    assert not (moved & (np.abs(vis_m) >= 1e-4)).any()
    lod_off = pv.lod.numpy() != np.asarray(rv.lod)
    assert not (lod_off & (np.abs(lod_m) >= 1e-4)).any()
    moved |= lod_off | (depth < PP.DEPTH_EPS)
    off = (pv.sort_key.numpy() != _np(rv.sort_key)) | (pv.sort_key_lo.numpy() != _np(rv.sort_key_lo))
    assert not (off & ~moved).any(), "a key differs away from every margin"
    worlds = ~off.any(-1)
    assert worlds.any()
    for f in VIEW_FIELDS[4:-2]:
        got, ref = getattr(pv, f).numpy()[worlds], _np(getattr(rv, f))[worlds]
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, rtol=0, atol=TRANSFORM_ATOL, err_msg=f)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f)
    light_off = pv.lights_visible.numpy() != np.asarray(rv.lights_visible)
    assert not (light_off & (np.abs(light_m) >= 1e-4)).any()
    return int(moved.sum())


@pytest.mark.parametrize("sort_mode", [PP.SORT_MATERIAL, PP.SORT_DEPTH])
def test_prepare_view_matches_reference(sort_mode):
    from lumixengine_tpu.renderer import pipeline as RP

    rworld, rstate, pworld, pstate = demo_batch()
    rm, pm = rworld.modules["renderer"], pworld.modules["renderer"]
    rv = jax.vmap(lambda s: RP.prepare_view(s, rm, sort_mode=sort_mode))(rstate)
    pv = PP.prepare_view(pstate, pm, sort_mode=sort_mode)
    check_view(rv, pv)
    vis = pv.visible.numpy()
    n = pv.visible_count.numpy()
    assert 0 < n.min() and n.max() < vis.shape[-1]
    # visible instances first, and the keys ascending in draw order
    order = pv.order.numpy().astype(np.int64)
    hi = np.take_along_axis(pv.sort_key.numpy(), order, -1)
    lo = np.take_along_axis(pv.sort_key_lo.numpy(), order, -1)
    assert np.all((np.diff(hi, axis=-1) > 0) | ((np.diff(hi, axis=-1) == 0)
                                                & (np.diff(lo, axis=-1) >= 0)))
    for w in range(len(n)):
        assert vis[w, order[w, :n[w]]].all() and not vis[w, order[w, n[w]:]].any()
    if sort_mode == PP.SORT_DEPTH:   # back to front: the transparent hi word
        assert (hi[:, : n.min()] < 0xFFFFFF00).all() and (hi >= 0).all()


def test_prepare_view_within_margins_after_stepping():
    """Each package steps its own state 3 frames from the same batch; the
    views agree outside the cull and LOD margins (`pipeline.cull_margins`)."""
    from lumixengine_tpu.models import demo_scenes as rds
    from lumixengine_tpu.renderer import pipeline as RP

    rengine, rworld, _r = rds.headless_demo_world(512)
    pengine, pworld, _p = pds.headless_demo_world(512)
    rstate = ref_replicate(rworld.device_state(), 4, jax.random.PRNGKey(12))
    pstate = bridge.state_from_numpy(ref_to_numpy(rstate), "cpu")
    rstep = reference_step(rengine, rworld, batched=True)
    pstep = pengine.build_step(pworld, "cpu", extra=pworld.modules["renderer"].cull_pass)
    for _ in range(FRAMES):
        rstate, pstate = rstep(rstate, jnp.float32(DT)), pstep(pstate, DT)
    rm, pm = rworld.modules["renderer"], pworld.modules["renderer"]
    for mode in (PP.SORT_MATERIAL, PP.SORT_DEPTH):
        rv = jax.vmap(lambda s: RP.prepare_view(s, rm, sort_mode=mode))(rstate)
        pv = PP.prepare_view(pstate, pm, sort_mode=mode)
        moved = check_view(rv, pv, PP.cull_margins(pstate, pm), PP.depth_margins(pstate, pm).numpy())
        print(f"sort mode {mode}: instances near a margin {moved}")


def _instanced_scene(package):
    """A camera at (0, 2, 10) looking down -Z; an instanced-model chunk in
    front of it and one far behind; three model instances; two lights."""
    engine, _renderer = package.build_engine(model_instances=64)
    world = engine.create_world(capacity=64)
    cam = world.create_entity(position=(0, 2, 10), name="camera")
    world.create_component(cam, "camera")
    front = world.create_entity(position=(0, 0, -20))
    world.create_component(front, "instanced_model", model="cube", count=3,
                           positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32))
    behind = world.create_entity(position=(0, 0, 500))
    world.create_component(behind, "instanced_model", model="cube", count=2,
                           positions=np.zeros((2, 3), np.float32))
    for i, model in enumerate(("cube", "rock", "tree")):
        e = world.create_entity(position=(3.0 * i - 3.0, 0.0, -5.0 * (i + 1)))
        world.create_component(e, "model_instance", model=model)
    for p in ((0, 3, -8), (0, 3, 400)):
        world.create_component(world.create_entity(position=p), "point_light", range=5.0)
    return engine, world, front, behind


def test_instanced_chunks_and_record_frame_match_reference():
    """As the JAX package's test_instanced_model_chunk_culling: the chunk in
    front is visible, the one behind is not; record_frame's opcodes and
    arguments equal the reference's."""
    from lumixengine_tpu.renderer import draw_stream as RD
    from lumixengine_tpu.renderer import pipeline as RP
    from lumixengine_tpu.models import demo_scenes as rds
    from lumixengine_tpu_torch.renderer import draw_stream as PD

    rengine, rworld, _f, _b = _instanced_scene(rds)
    pengine, pworld, front, behind = _instanced_scene(pds)
    rm, pm = rworld.modules["renderer"], pworld.modules["renderer"]
    rstate = reference_step(rengine, rworld, batched=False)(rworld.device_state(),
                                                             jnp.float32(DT))
    pstate = pengine.build_step(pworld, "cpu", extra=pm.cull_pass)(pworld.device_state("cpu"), DT)
    rv, pv = RP.prepare_view(rstate, rm), PP.prepare_view(pstate, pm)
    check_view(rv, pv)
    vis = pv.instanced_visible.numpy()
    st = pm.statics()
    by_slot = {int(s): i for i, s in enumerate(st.im_slots)}
    assert vis.shape == (2,) and vis[by_slot[pworld.slot(front)]]
    assert not vis[by_slot[pworld.slot(behind)]]
    np.testing.assert_array_equal(st.im_centers, rm.statics().im_centers)
    np.testing.assert_array_equal(st.im_radii, rm.statics().im_radii)

    rs_ = RD.record_frame(rv, rstate.modules["renderer"], rm)
    ps_ = PD.record_frame(pv, pstate.modules["renderer"], pm)
    assert [c.op for c in ps_.commands] == [c.op for c in rs_.commands]
    for pc, rc in zip(ps_.commands, rs_.commands):
        assert set(pc.args) == set(rc.args), pc.op
        for k, v in pc.args.items():
            if isinstance(v, torch.Tensor):
                np.testing.assert_array_equal(v.numpy(), _np(rc.args[k]), err_msg=f"{pc.op}.{k}")
            else:
                assert v == rc.args[k], (pc.op, k)
    assert len([c for c in ps_.commands if c.args.get("source") == "instanced_model"]) == 1


def test_draw_stream_plugins_substreams_and_replay():
    from lumixengine_tpu_torch.renderer import draw_stream as PD

    pengine, pworld, _f, _b = _instanced_scene(pds)
    pm = pworld.modules["renderer"]

    class Tonemapper(PD.RenderPlugin):
        def tonemap(self, stream, view, module):
            stream.push(PD.OP_DISPATCH, shader="aces")
            return True

    pm.system.add_plugin(Tonemapper())
    state = pengine.build_step(pworld, "cpu", extra=pm.cull_pass)(pworld.device_state("cpu"), DT)
    s = PD.record_frame(PP.prepare_view(state, pm), state.modules["renderer"], pm)
    shaders = [c.args.get("shader") for c in s.commands if c.op == PD.OP_DISPATCH]
    assert shaders == ["deferred_lights", "aces"]

    class Recorder:
        def __init__(self):
            self.ops = []

        def __getattr__(self, name):
            return lambda **kw: self.ops.append(name)

    rec = Recorder()
    assert s.replay(rec) == len(rec.ops) == len(s.commands)
    root = PD.DrawStream()
    a, b = root.substream("a"), root.substream("b")
    b.push(PD.OP_SET_PASS, name="B")
    a.push(PD.OP_SET_PASS, name="A")
    root.merge()
    assert [c.args["name"] for c in root.commands] == ["A", "B"]


def close_relative(got, ref, name):
    np.testing.assert_allclose(got, ref, rtol=0, atol=GEOM_RTOL * np.abs(ref).max(), err_msg=name)


def check_shadows(rsv, psv, margins):
    """Cascade geometry within GEOM_RTOL; casters equal outside
    PS.SHADOW_MARGIN, counts off by at most the flips. Returns the flips."""
    for f in ("splits", "center", "radius", "light_pos", "extent"):
        close_relative(getattr(psv, f).numpy(), np.asarray(getattr(rsv, f)), f)
    off = psv.casters.numpy() != np.asarray(rsv.casters)
    assert not (off & (np.abs(margins.numpy()) >= PS.SHADOW_MARGIN)).any()
    diff = np.abs(psv.caster_count.numpy().astype(np.int64) - np.asarray(rsv.caster_count))
    assert (diff <= off.sum(-1)).all()
    return int(off.sum())


def test_shadow_pass_and_cascade_matrices_match_reference():
    from lumixengine_tpu.renderer import shadows as RS

    rworld, rstate, pworld, pstate = demo_batch()
    rm, pm = rworld.modules["renderer"], pworld.modules["renderer"]
    rsv = jax.vmap(lambda s: RS.shadow_pass(s, rm, light_dir=LIGHT_DIR))(rstate)
    psv = PS.shadow_pass(pstate, pm, light_dir=LIGHT_DIR)
    assert psv.casters.shape == (4, PS.NUM_CASCADES, pm.model_instances.capacity)
    flips = check_shadows(rsv, psv, PS.caster_margins(pstate, pm, psv, LIGHT_DIR))
    print(f"caster flips {flips}; counts {psv.caster_count.tolist()}")
    counts = psv.caster_count.numpy()
    assert (counts > 0).all() and (counts[:, -1] >= counts[:, 0]).all()
    assert (np.diff(psv.radius.numpy(), axis=-1) > 0).all()
    # the worlds differ (each has its own camera pose), so reducing over
    # the batch would be visible here
    assert len({tuple(r) for r in psv.center.numpy().reshape(4, -1).round(4)}) == 4
    rmat = jax.vmap(lambda s: RS.cascade_matrices(s, LIGHT_DIR))(rsv)
    close_relative(PS.cascade_matrices(psv, LIGHT_DIR).numpy(), np.asarray(rmat), "matrices")


@pytest.mark.parametrize("light_dir", [(0.3, -1.0, 0.2), (0.0, -1.0, 0.0), (1.0, 0.2, -0.5)])
def test_light_rotation_matches_reference(light_dir):
    from lumixengine_tpu.renderer import shadows as RS

    got = PS.light_rotation(torch.tensor(light_dir)).numpy()
    np.testing.assert_allclose(got, np.asarray(RS.light_rotation(light_dir)), rtol=0, atol=1e-7)


def reference_words(rm, rstate):
    """The reference's bitset words of camera 0, through its own functions,
    under vmap."""
    from lumixengine_tpu.core import math as rlm
    from lumixengine_tpu.renderer import clusters as RC

    st = rm.statics()
    cam_e = max(int(st.cam_slots[0]), 0)

    def one(ws):
        rs = ws.modules["renderer"]
        mins, maxs = RC._cluster_bounds(rs.cam_near[0], rs.cam_far[0], rs.cam_fov[0],
                                        rs.cam_aspect[0], RC.GRID)
        lw = jnp.take(ws.world.pos, jnp.asarray(np.maximum(st.pl_slots, 0)), axis=-1)
        cpos, crot = ws.world.pos[:, cam_e], ws.world.rot[:, cam_e]
        inv = rlm.quat_conjugate(crot)
        lv = jnp.moveaxis(rlm.quat_rotate(inv[:, None], lw - cpos[:, None], axis=-2), -2, -1)
        return RC._touch_words(lv, rs.pl_range, jnp.asarray(st.pl_mask), mins, maxs)

    return np.asarray(jax.vmap(one)(rstate)).astype(np.int64)


def check_clusters(rcl, rwords, pcl, inputs):
    """Words, lists, counts and overflow bit-equal, apart from the tests
    within PC.CLUSTER_D2_EPS of the range (and the clusters holding one).
    Returns the flipped tests."""
    pwords = PC._touch_words(*inputs)
    off = PC.unpack_words(pwords ^ torch.as_tensor(rwords)).numpy()
    near = PC.touch_margins(*inputs).numpy() < PC.CLUSTER_D2_EPS
    assert not (off & ~near).any(), "a light-cluster test differs away from its range"
    same = ~off.any(-1)
    np.testing.assert_array_equal(pcl.lights.numpy()[same], np.asarray(rcl.lights)[same])
    np.testing.assert_array_equal(pcl.count.numpy()[same], np.asarray(rcl.count)[same])
    flips = int(off.sum())
    assert (np.abs(pcl.overflow.numpy().astype(np.int64) - np.asarray(rcl.overflow))
            <= flips).all()
    return flips


def test_fill_clusters_matches_reference():
    from lumixengine_tpu.renderer import clusters as RC

    rworld, rstate, pworld, pstate = demo_batch()
    rm, pm = rworld.modules["renderer"], pworld.modules["renderer"]
    rcl = jax.vmap(lambda s: RC.fill_clusters(s, rm))(rstate)
    pcl = PC.fill_clusters(pstate, pm)
    c = int(np.prod(PC.GRID))
    assert pcl.lights.shape == (4, c, PC.MAX_LIGHTS_PER_CLUSTER) and pcl.count.shape == (4, c)
    flips = check_clusters(rcl, reference_words(rm, rstate), pcl, PC.cluster_inputs(pstate, pm))
    print(f"cluster test flips {flips}; lights binned {pcl.count.sum(-1).tolist()}")
    assert (pcl.count.numpy().sum(-1) > 0).all()
    np.testing.assert_array_equal(pcl.lights.numpy(), np.asarray(rcl.lights))


def test_cluster_bounds_per_world():
    """Each world's own near/far/fov/aspect give its own cluster AABBs,
    those of the reference's _cluster_bounds for that world."""
    from lumixengine_tpu.renderer import clusters as RC

    near = np.float32([0.1, 0.3, 1.0])
    far = np.float32([100.0, 500.0, 60.0])
    fov = np.float32([1.0, 1.2, 0.7])
    aspect = np.float32([1.0, 16 / 9, 2.0])
    mins, maxs = PC._cluster_bounds(*(torch.tensor(a) for a in (near, far, fov, aspect)), PC.GRID)
    for w in range(3):
        rmin, rmax = RC._cluster_bounds(jnp.float32(near[w]), jnp.float32(far[w]),
                                        jnp.float32(fov[w]), jnp.float32(aspect[w]), RC.GRID)
        np.testing.assert_allclose(mins[w].numpy(), np.asarray(rmin), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(maxs[w].numpy(), np.asarray(rmax), rtol=1e-6, atol=1e-6)


def _random_cluster_case(rng, c, n_lights, batch=()):
    mins = rng.uniform(-10, 0, batch + (c, 3)).astype(np.float32)
    maxs = mins + rng.uniform(0.5, 3, batch + (c, 3)).astype(np.float32)
    lv = rng.uniform(-10, 3, batch + (n_lights, 3)).astype(np.float32)
    r = rng.uniform(0.5, 4, batch + (n_lights,)).astype(np.float32)
    mask = rng.uniform(size=n_lights) > 0.3
    return lv, r, mask, mins, maxs


@pytest.mark.parametrize("c,n_lights,batch", [(48, 70, ()), (96, 256, ()), (16, 32, ()),
                                              (48, 70, (3,))])
def test_touch_words_chunked_matches_dense(c, n_lights, batch):
    """The card path (word groups) is bit for bit the dense oracle, and both
    are the reference's words."""
    from lumixengine_tpu.renderer import clusters as RC

    case = _random_cluster_case(np.random.default_rng(3), c, n_lights, batch)
    t = [torch.as_tensor(a) for a in case]
    got = PC._touch_words(*t)
    assert torch.equal(got, PC._touch_words_dense(*t))
    ref = RC._touch_words_dense
    for _ in batch:
        ref = jax.vmap(ref, in_axes=(0, 0, None, 0, 0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref(*map(jnp.asarray, case))))


def test_assign_bitset_matches_reference_with_overflow():
    from lumixengine_tpu.renderer import clusters as RC

    lv, r, mask, mins, maxs = _random_cluster_case(np.random.default_rng(0), 48, 70)
    ref = RC._assign_bitset(*map(jnp.asarray, (lv, r, mask, mins, maxs)), 8)
    got = PC._assign_bitset(*map(torch.as_tensor, (lv, r, mask, mins, maxs)), 8)
    assert int(np.asarray(ref.overflow)) > 0
    for f in ("lights", "count", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))


def test_swar_popcount_matches_population_count():
    rng = np.random.default_rng(5)
    words = np.concatenate([
        np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000001], np.uint64),
        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64),
        rng.integers(0, 2 ** 32, 1024, dtype=np.uint64) | np.uint64(0x80000000)])
    got = PC.popcount32(torch.as_tensor(words.astype(np.int64))).numpy()
    ref = np.asarray(jax.lax.population_count(jnp.asarray(words.astype(np.uint32))))
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    # the low 32 bits only, as a uint32 word would hold them (lsb - 1 of an empty word)
    assert PC.popcount32(torch.tensor([-1, 1 << 40])).tolist() == [32, 0]


def _attached_crowd(package):
    """skinned_crowd_world(4) with a sword on bone 5 of the first animable
    and a lamp (offset rotation too) on bone 9 of the first animator."""
    engine, world, _renderer, _anim = package.skinned_crowd_world(num_characters=4)
    amod = world.modules["animation"]
    char = int(amod.animables.entity[amod.animables.entity >= 0][0])
    walker = int(amod.animators.entity[amod.animators.entity >= 0][0])
    sword = world.create_entity(name="sword")
    world.create_component(sword, "bone_attachment", parent_entity=char, bone=5,
                           offset_pos=(0.0, 0.2, 0.0))
    lamp = world.create_entity(name="lamp")
    world.create_component(lamp, "bone_attachment", parent_entity=walker, bone=9,
                           offset_pos=(0.1, 0.0, -0.3),
                           offset_rot=(0.0, np.sin(0.4), 0.0, np.cos(0.4)))
    return engine, world, char, sword, lamp


def test_bone_attachment_three_frames_match_reference():
    """3 frames of the crowd with two attachments in both packages, every
    field; each attachment's local = its bone's model-space pose ∘ offset
    (the JAX package's test_bone_attachment_follows_bone), and it moves."""
    from lumixengine_tpu.models import demo_scenes as rds
    from lumixengine_tpu_torch.core import host_math as hm

    rengine, rworld, _c, _s, _l = _attached_crowd(rds)
    pengine, pworld, char, sword, lamp = _attached_crowd(pds)
    assert pworld.get_parent(sword) == char
    rstep = reference_step(rengine, rworld, batched=False)
    pstep = pengine.build_step(pworld, "cpu", extra=pworld.modules["renderer"].cull_pass)
    rstate = rworld.device_state()
    pstate = bridge.state_from_numpy(ref_to_numpy(rstate), "cpu")
    errs, prev = {}, None
    for _ in range(FRAMES):
        rstate, pstate = rstep(rstate, jnp.float32(DT)), pstep(pstate, DT)
        got, ref = bridge.state_to_numpy(pstate), ref_to_numpy(rstate)
        compare(pworld, pstate, got, ref, errs)
        assert_rest_equal(got, ref, compare_arms(got, ref, errs))
        slot = pworld.slot(sword)
        if prev is not None:
            assert not np.allclose(prev, got["local.pos"][:, slot])
        prev = got["local.pos"][:, slot]
    print("max abs err", {k: v for k, v in errs.items() if v > 0})
    amod = pworld.modules["animation"]
    ams = pstate.modules["animation"]
    col = amod.pool_col_animable(amod.animables.slot_of(char))
    bp, br = ams.pose_pos[:, 5, col].numpy(), ams.pose_rot[:, 5, col].numpy()
    np.testing.assert_allclose(pstate.local.pos[:, pworld.slot(sword)].numpy(),
                               bp + hm.quat_rotate(br, np.array([0, 0.2, 0], np.float32)),
                               atol=1e-5)
    walker = int(pworld.get_parent(lamp))
    col = amod.pool_col_animator(amod.animators.slot_of(walker))
    np.testing.assert_allclose(pstate.local.rot[:, pworld.slot(lamp)].numpy(),
                               hm.quat_mul(ams.pose_rot[:, 9, col].numpy(),
                                           np.array([0, np.sin(0.4), 0, np.cos(0.4)], np.float32)),
                               atol=1e-6)


def test_late_update_returns_at_once_without_attachments():
    _e, world, *_ = pds.full_frame_world(*FLAGSHIP_TEST)
    state = world.device_state("cpu")
    assert world.modules["renderer"].late_update(state, DT) is state


def test_attachment_wiring_follows_animation_membership():
    """The attachment wiring is part of the view statics: an attachment
    whose parent is not animated is left out, and the statics are rebuilt
    when the parent gains an animable (no hierarchy change)."""
    _e, world, _r, _a = pds.skinned_crowd_world(num_characters=4)
    rm, amod = world.modules["renderer"], world.modules["animation"]
    prop, sword = world.create_entity(name="prop"), world.create_entity(name="sword")
    world.create_component(sword, "bone_attachment", parent_entity=prop, bone=3)
    assert rm.statics().ba_flat.size == 0
    world.create_component(prop, "animable", clip="walk")
    statics = rm.statics()
    col = amod.pool_col_animable(amod.animables.slot_of(prop))
    assert statics.ba_flat.tolist() == [3 * amod.pool_size + col]
    assert statics.ba_slots.tolist() == [world.slot(sword)]


@pytest.mark.parametrize("num_worlds", [2])
def test_render_frame_matches_reference(num_worlds):
    """The render config at test size: full_frame_world(512, 8, 32, 256)
    replicated to 2 worlds, 3 frames of build_step(extra=cull_pass), each
    followed by shadow_pass and fill_clusters, every field and both passes
    against the reference."""
    from lumixengine_tpu.models import demo_scenes as rds
    from lumixengine_tpu.renderer import clusters as RC
    from lumixengine_tpu.renderer import shadows as RS

    rengine, rworld, *_ = rds.full_frame_world(*FLAGSHIP_TEST)
    pengine, pworld, *_ = pds.full_frame_world(*FLAGSHIP_TEST)
    rm, pm = rworld.modules["renderer"], pworld.modules["renderer"]
    rstate = ref_replicate(rworld.device_state(), num_worlds, jax.random.PRNGKey(13))
    pstate = bridge.state_from_numpy(ref_to_numpy(rstate), "cpu")
    rstep = reference_step(rengine, rworld, batched=True)
    rpasses = jax.jit(jax.vmap(lambda s: (RS.shadow_pass(s, rm, light_dir=LIGHT_DIR),
                                          RC.fill_clusters(s, rm))))
    pstep = pengine.build_step(pworld, "cpu", extra=pm.cull_pass)
    errs, flips = {}, []
    for _ in range(FRAMES):
        rstate, pstate = rstep(rstate, jnp.float32(DT)), pstep(pstate, DT)
        got, ref = bridge.state_to_numpy(pstate), ref_to_numpy(rstate)
        compare(pworld, pstate, got, ref, errs)
        compare_arms(got, ref, errs)
        rsv, rcl = rpasses(rstate)
        psv = PS.shadow_pass(pstate, pm, light_dir=LIGHT_DIR)
        pcl = PC.fill_clusters(pstate, pm)
        flips.append((check_shadows(rsv, psv, PS.caster_margins(pstate, pm, psv, LIGHT_DIR)),
                      check_clusters(rcl, reference_words(rm, rstate), pcl,
                                     PC.cluster_inputs(pstate, pm))))
    print(f"W={num_worlds}: (caster, cluster) flips {flips}; max abs err",
          {k: v for k, v in errs.items() if v > 0})
    assert (psv.caster_count.numpy() > 0).all() and (pcl.count.numpy().sum(-1) > 0).all()
