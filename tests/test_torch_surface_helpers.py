"""The port's remaining public helpers against the JAX package, on the CPU:
``renderer/culling_system.cull``, ``ops/skinning.py`` (``blend_palette``,
``skin_points``, ``weights_matrix``), ``ops/sampling.py`` (``two_hot``,
``sample_bank``), ``core/geometry.py``'s AABB, overlap and ray tests,
``core/math.py``'s constructors, slerp, Euler and matrix conversions and
scalar helpers, ``core/transform.py``'s ``inverse``, ``compute_local``,
``transform_point`` and ``transform_vector``, the animation time helpers,
``parallel/mesh.WORLD_AXIS``, and ``core/debug.enable_floating_point_traps``
on an engine step; and an AST scan that every public top-level name of the
JAX package has a namesake in the port, but for those ROADMAP.md lists as
kept without one.

Tolerances: elementwise float32 formulas written term by term as in the
JAX package agree within ATOL = 1e-6 (the transcendental functions of XLA
and PyTorch may differ by an ulp); slerp, whose arccos near 1 amplifies an
ulp, within 1e-5; skinning within SKIN_ATOL = 1e-5 (the blend is a matrix
product summed in another order) and, against the host's 4-bone formula,
within the JAX test's 2e-3. Integer and boolean results, and the cull's
mask away from its threshold (assert_masks_agree, 1e-5), are equal.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu.core import geometry as rgeom
from lumixengine_tpu.core import host_math as rhm
from lumixengine_tpu.core import math as rlm
from lumixengine_tpu.core import transform as rxf
from lumixengine_tpu.ops import sampling as rsamp
from lumixengine_tpu.ops import skinning as rskin
from lumixengine_tpu.renderer import culling_system as rcs
from lumixengine_tpu_torch.core import debug
from lumixengine_tpu_torch.core import geometry as pgeom
from lumixengine_tpu_torch.core import math as plm
from lumixengine_tpu_torch.core import transform as pxf
from lumixengine_tpu_torch.ops import sampling as psamp
from lumixengine_tpu_torch.ops import skinning as pskin
from lumixengine_tpu_torch.renderer import culling_system as pcs
from test_torch_bridge import assert_masks_agree

torch.set_num_threads(1)

ATOL = 1e-6
SKIN_ATOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, atol=ATOL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol, err_msg=what)


def rand_quats(rng, *shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# -- core/math.py ------------------------------------------------------------------------

def test_constructors_and_scalar_helpers_match_reference():
    rng = np.random.default_rng(0)
    x, y, z, w = (rng.normal(size=5).astype(np.float32) for _ in range(4))
    close(plm.vec3(T(x), T(y), T(z)), rlm.vec3(x, y, z))
    close(plm.vec3(1.0, 2.0, 3.0, axis=-1), rlm.vec3(1.0, 2.0, 3.0))
    close(plm.vec3(T(x), T(y), T(z), axis=0), rlm.vec3(x, y, z, axis=0))
    close(plm.quat(T(x), T(y), T(z), T(w)), rlm.quat(x, y, z, w))
    close(plm.stack([T(x), T(y)], axis=-2), rlm.stack([x, y], axis=-2))
    v = rng.normal(size=(4, 3, 9)).astype(np.float32)
    close(plm.length(T(v), axis=-2), rlm.length(jnp.asarray(v), axis=-2))
    close(plm.squared_length(T(v), axis=-2), rlm.squared_length(jnp.asarray(v), axis=-2))
    a, b, t = v[0], v[1], rng.uniform(size=(3, 9)).astype(np.float32)
    close(plm.lerp(T(a), T(b), T(t)), rlm.lerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
    close(plm.quat_identity((2, 3)), rlm.quat_identity((2, 3)))
    close(plm.QUAT_IDENTITY, rlm.QUAT_IDENTITY)
    with pytest.raises(ValueError):
        plm.quat_identity((2,), axis=-2)
    d = rng.uniform(-720, 720, 7).astype(np.float32)
    close(plm.degrees_to_radians(T(d)), rlm.degrees_to_radians(d))
    close(plm.radians_to_degrees(T(d)), rlm.radians_to_degrees(d), atol=1e-4)
    close(plm.degrees_to_radians(90.0), rlm.degrees_to_radians(90.0))
    close(plm.clamp(T(d), -100.0, 250.0), rlm.clamp(d, -100.0, 250.0))


def test_rotation_constructors_match_reference():
    rng = np.random.default_rng(1)
    for pitch, yaw, roll in rng.uniform(-3.2, 3.2, (6, 3)):
        close(plm.quat_from_euler(float(pitch), float(yaw), float(roll)),
              rlm.quat_from_euler(pitch, yaw, roll))
    axis = rng.normal(size=(3, 11)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=0)
    ang = rng.uniform(-6, 6, 11).astype(np.float32)
    close(plm.quat_from_axis_angle(T(axis), T(ang), axis=-2),
          rlm.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(ang), axis=-2))
    # every branch of Shepperd's form: random turns, and half turns about x, y and z
    qs = np.concatenate([rand_quats(rng, 20),
                         np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                                  np.float32)])
    m = np.asarray(rlm.quat_to_mat3(jnp.asarray(qs)))
    got = plm.mat3_to_quat(T(m))
    close(got, rlm.mat3_to_quat(jnp.asarray(m)))
    # tests/test_math.py: the round trip, up to the quaternion's sign
    dots = np.abs(np.sum(got.numpy() * qs, axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-5)


def test_slerp_matches_reference():
    rng = np.random.default_rng(2)
    a, b = rand_quats(rng, 16), rand_quats(rng, 16)
    b[:4] = a[:4] + rng.normal(scale=1e-4, size=(4, 4)).astype(np.float32)   # nlerp branch
    b[4:6] = -a[4:6]                                                          # other hemisphere
    t = rng.uniform(size=16).astype(np.float32)
    close(plm.quat_slerp(T(a), T(b), T(t)), rlm.quat_slerp(jnp.asarray(a), jnp.asarray(b),
                                                           jnp.asarray(t)), atol=1e-5)
    close(plm.quat_slerp(T(a), T(b), 0.25), rlm.quat_slerp(jnp.asarray(a), jnp.asarray(b), 0.25),
          atol=1e-5)
    # SoA form [4, N] and tests/test_math.py's endpoints
    close(plm.quat_slerp(T(a.T), T(b.T), T(t), axis=-2),
          rlm.quat_slerp(jnp.asarray(a.T), jnp.asarray(b.T), jnp.asarray(t), axis=-2), atol=1e-5)
    close(plm.quat_slerp(T(a), T(b[::-1].copy()), 0.0), a, atol=1e-5)


# -- core/transform.py -------------------------------------------------------------------

def _transforms(rng, n=13, uniform=False):
    pos = rng.normal(size=(3, n)).astype(np.float32)
    rot = rand_quats(rng, n).T.copy()
    s = rng.uniform(0.5, 2.0, size=(1 if uniform else 3, n)).astype(np.float32)
    scale = np.broadcast_to(s, (3, n)).copy()
    return (pos, rot, scale)


@pytest.mark.parametrize("uniform", [False, True])
def test_transform_helpers_match_reference(uniform):
    rng = np.random.default_rng(3 + uniform)
    a, b = _transforms(rng, uniform=uniform), _transforms(rng, uniform=uniform)
    pa, pb = pxf.Transform(*map(T, a)), pxf.Transform(*map(T, b))
    ra, rb = rxf.Transform(*map(jnp.asarray, a)), rxf.Transform(*map(jnp.asarray, b))
    for name, got, ref in (("inverse", pxf.inverse(pa), rxf.inverse(ra)),
                           ("compute_local", pxf.compute_local(pa, pb), rxf.compute_local(ra, rb))):
        for f in ("pos", "rot", "scale"):
            close(getattr(got, f), getattr(ref, f), atol=1e-5, what=f"{name}.{f}")
    p = rng.normal(size=(3, 13)).astype(np.float32)
    close(pxf.transform_point(pa, T(p)), rxf.transform_point(ra, jnp.asarray(p)), atol=1e-5)
    close(pxf.transform_vector(pa, T(p)), rxf.transform_vector(ra, jnp.asarray(p)), atol=1e-5)
    # tests/test_math.py: compute_local inverts compose; for uniform scale the
    # inverse undoes the transform
    back = pxf.compose(pa, pxf.compute_local(pa, pb))
    close(back.pos, b[0], atol=1e-4)
    if uniform:
        ident = pxf.compose(pa, pxf.inverse(pa))
        close(ident.pos, np.zeros_like(a[0]), atol=1e-4)
        close(ident.scale, np.ones_like(a[2]), atol=1e-5)


# -- core/geometry.py --------------------------------------------------------------------

def _frustum(pkg, rot=None):
    """A 90° camera at the origin, looking along -Z rotated by `rot`."""
    rot = np.array([0, 0, 0, 1], np.float32) if rot is None else rot
    if pkg == "jax":
        return rgeom.perspective_frustum(jnp.zeros(3), jnp.asarray(rot), jnp.float32(np.pi / 2),
                                         1.0, 0.1, 100.0)
    return pgeom.perspective_frustum(torch.zeros(3), T(rot), float(np.pi / 2), 1.0, 0.1, 100.0)


def test_geometry_tests_match_reference():
    assert pgeom.NUM_PLANES == rgeom.NUM_PLANES == 8
    rng = np.random.default_rng(5)
    for rot in (None, rand_quats(rng, 1)[0]):
        rf, pf = _frustum("jax", rot), _frustum("torch", rot)
        c = rng.uniform(-60, 60, (3, 400)).astype(np.float32)
        h = rng.uniform(0.1, 8, (3, 400)).astype(np.float32)
        got = pgeom.frustum_contains_aabb(pf, T(c - h), T(c + h))
        ref = rgeom.frustum_contains_aabb(rf, jnp.asarray(c - h), jnp.asarray(c + h))
        assert 0 < int(got.sum()) < 400
        # the p-vertex distance's margin: decisions within 1e-3 of 0 may round apart
        planes = np.asarray(rf.planes).astype(np.float64)
        pv = np.where(planes[:, :3, None] >= 0, (c + h)[None], (c - h)[None])
        margin = (np.sum(pv * planes[:, :3, None], 1) + planes[:, 3:]).min(0)
        assert_masks_agree("frustum_contains_aabb", got.numpy(), np.asarray(ref), margin, 1e-3)
    # tests/test_culling.py's cases
    pf = _frustum("torch")
    mins = torch.tensor([[-1.0, -1.0, -11.0], [80.0, 80.0, -60.0]]).T
    maxs = torch.tensor([[1.0, 1.0, -9.0], [82.0, 82.0, -58.0]]).T
    assert pgeom.frustum_contains_aabb(pf, mins, maxs).tolist() == [True, False]
    hit, t = pgeom.ray_sphere(torch.zeros(3), torch.tensor([0.0, 0.0, -1.0]),
                              torch.tensor([0.0, 0.0, -10.0]), 1.0)
    assert bool(hit) and abs(float(t) - 9.0) < 1e-5
    hit, t = pgeom.ray_aabb(torch.zeros(3), torch.tensor([0.0, 0.0, -1.0]),
                            torch.tensor([-1.0, -1.0, -12.0]), torch.tensor([1.0, 1.0, -8.0]))
    assert bool(hit) and abs(float(t) - 8.0) < 1e-5


def test_overlap_and_ray_primitives_match_reference():
    rng = np.random.default_rng(6)
    n = 64
    ca, cb = (rng.uniform(-3, 3, (n, 3)).astype(np.float32) for _ in range(2))
    ra, rb = (rng.uniform(0.1, 2, n).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        pgeom.sphere_sphere_overlap(T(ca), T(ra), T(cb), T(rb)).numpy(),
        np.asarray(rgeom.sphere_sphere_overlap(ca, ra, cb, rb)))
    ha, hb = (rng.uniform(0.1, 2, (n, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        pgeom.aabb_overlap(T(ca - ha), T(ca + ha), T(cb - hb), T(cb + hb)).numpy(),
        np.asarray(rgeom.aabb_overlap(ca - ha, ca + ha, cb - hb, cb + hb)))
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4, 0] = 0.0                                           # the slab test's axis-parallel rays
    d[:4] /= np.linalg.norm(d[:4], axis=-1, keepdims=True)
    for name, got, ref in (
            ("ray_sphere", pgeom.ray_sphere(T(o), T(d), T(ca), T(ra)),
             rgeom.ray_sphere(o, d, ca, ra)),
            ("ray_aabb", pgeom.ray_aabb(T(o), T(d), T(ca - ha), T(ca + ha)),
             rgeom.ray_aabb(o, d, ca - ha, ca + ha)),
            ("ray_plane", pgeom.ray_plane(T(o), T(d), T(d[::-1].copy()), T(ra)),
             rgeom.ray_plane(o, d, d[::-1].copy(), ra))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]), err_msg=name)
        assert 0 < int(got[0].sum()) < n, name
        close(got[1], ref[1], atol=1e-4, what=name)


# -- renderer/culling_system.py ----------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_cull_matches_reference(batched):
    """cull over a store with empty slots and entities scaled unevenly (the
    radius takes the largest absolute scale), against the JAX cull."""
    rng = np.random.default_rng(7 + batched)
    n, k, w = 300, 256, 3
    entity = rng.choice(n, k, replace=False).astype(np.int32)
    entity[rng.choice(k, 20, replace=False)] = -1
    radius = rng.uniform(0.2, 3, k).astype(np.float32)
    shape = (w, 3, n) if batched else (3, n)
    pos = rng.uniform(-60, 60, shape).astype(np.float32)
    scale = rng.uniform(-2, 2, shape).astype(np.float32)
    rf = _frustum("jax", rand_quats(rng, 1)[0])
    planes = np.asarray(rf.planes)
    ref_fn = lambda p, s: rcs.cull(rcs.CullingState(jnp.asarray(entity), jnp.asarray(radius)),  # noqa: E731
                                   p, s, rf, use_pallas=False)
    ref = (jax.vmap(ref_fn)(jnp.asarray(pos), jnp.asarray(scale)) if batched
           else ref_fn(jnp.asarray(pos), jnp.asarray(scale)))
    cs = pcs.CullingState(T(entity), T(radius))
    pl = T(np.broadcast_to(planes, (w, 8, 4)).copy()) if batched else T(planes)
    got = pcs.cull(cs, T(pos), T(scale), pl)
    assert got.shape == ref.shape and got.dtype == torch.bool
    e = np.maximum(entity, 0)
    c = pos[..., e].astype(np.float64)
    r = radius * np.abs(scale[..., e]).max(-2)
    margin = (np.einsum("pj,...jk->...pk", planes[:6, :3].astype(np.float64), c)
              + planes[:6, 3:]).min(-2) + r
    assert_masks_agree("cull", got.numpy(), np.asarray(ref), margin, boundary=1e-5)
    assert not got.numpy()[..., entity < 0].any()
    assert 0 < int(got.sum()) < got.numel()
    # a Frustum is taken as its planes
    if not batched:
        assert torch.equal(pcs.cull(cs, T(pos), T(scale), _frustum("torch")),
                           pcs.cull(cs, T(pos), T(scale), _frustum("torch").planes))


def test_culling_system_store_matches_reference():
    ref, got = rcs.CullingSystem(8), pcs.CullingSystem(8)
    for sysm in (ref, got):
        sysm.add(3, 1.5)
        sysm.add(5, 2.0)
        sysm.set_radius(5, 4.0)
        sysm.remove(3)
    assert got.is_added(5) and not got.is_added(3)
    assert ref.is_added(5) and not ref.is_added(3)
    np.testing.assert_array_equal(got.store.data["radius"], ref.store.data["radius"])


# -- ops/skinning.py, ops/sampling.py ----------------------------------------------------

def _palette(rng, b, a):
    real = rand_quats(rng, b, a)
    trans = rng.uniform(-2, 2, (b, a, 3)).astype(np.float32)
    tq = np.concatenate([trans, np.zeros((b, a, 1), np.float32)], -1)
    dual = 0.5 * rhm.quat_mul(tq.reshape(-1, 4), real.reshape(-1, 4)).reshape(b, a, 4)
    return np.moveaxis(np.concatenate([real, dual], -1), -1, 0).astype(np.float32)   # [8, B, A]


def test_skinning_matches_reference():
    rng = np.random.default_rng(8)
    b, v, a = 7, 50, 3
    bones4 = rng.integers(0, b, (v, 4)).astype(np.int32)
    wts = rng.uniform(0, 1, (v, 4)).astype(np.float32)
    wts /= wts.sum(-1, keepdims=True)
    wbv = pskin.weights_matrix(bones4, wts, b)
    np.testing.assert_array_equal(wbv, rskin.weights_matrix(bones4, wts, b))
    pal = _palette(rng, b, a)
    for lead in ((), (2,)):                       # a leading batch axis too
        p = np.broadcast_to(pal, lead + pal.shape).copy()
        blended = pskin.blend_palette(T(p), wbv)
        ref_b = rskin.blend_palette(jnp.asarray(p), jnp.asarray(wbv))
        close(blended, ref_b, atol=SKIN_ATOL, what="blend_palette")
        pts = rng.uniform(-1, 1, (3, v)).astype(np.float32)
        close(pskin.skin_points(blended, T(pts)), rskin.skin_points(ref_b, jnp.asarray(pts)),
              atol=SKIN_ATOL, what="skin_points")


def test_skinning_flows_of_the_reference_tests():
    from lumixengine_tpu_torch.core import host_math as phm
    from lumixengine_tpu_torch.renderer.gpu_soft import skin_points_dq_np

    # tests/test_animation_ops.py: one bone, every vertex on it → a rigid transform
    rng = np.random.default_rng(4)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    t = rng.normal(size=3).astype(np.float32)
    pal = plm.dual_quat_from_rigid(T(q)[:, None, None], T(t)[:, None, None], axis=-3)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    w = pskin.weights_matrix(np.zeros((5, 1), np.int32), np.ones((5, 1), np.float32), 1)
    out = pskin.skin_points(pskin.blend_palette(pal, w), T(pts.T))
    close(out[:, :, 0].T, phm.quat_rotate(q, pts) + t, atol=1e-4)
    # tests/test_postprocess.py: the host's 4-bone formula equals the device path
    rng = np.random.default_rng(5)
    b, v = 6, 40
    pal = _palette(rng, b, 1)[..., 0]
    bones4 = rng.integers(0, b, (v, 4)).astype(np.int32)
    w = rng.uniform(0, 1, (v, 4)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    pts = rng.uniform(-1, 1, (v, 3)).astype(np.float32)
    host = skin_points_dq_np(pal, pts, bones4, w)
    dev = pskin.skin_points(pskin.blend_palette(T(pal)[..., None],
                                                pskin.weights_matrix(bones4, w, b)), T(pts.T))
    close(dev[..., 0].T, host, atol=2e-3)


def test_two_hot_and_sample_bank_match_reference():
    rng = np.random.default_rng(9)
    cf, a, rows = 40, 12, 21
    f0 = rng.integers(0, cf, a)
    f1 = np.minimum(f0 + 1, cf - 1)
    f1[:2] = f0[:2]                                           # the two rows meet: summed
    w0, w1 = (rng.uniform(0, 1, a).astype(np.float32) for _ in range(2))
    got = psamp.two_hot(T(f0), T(f1), T(w0), T(w1), cf)
    ref = rsamp.two_hot(jnp.asarray(f0, jnp.int32), jnp.asarray(f1, jnp.int32), jnp.asarray(w0),
                        jnp.asarray(w1), cf)
    close(got, ref)
    table = rng.normal(size=(rows, cf)).astype(np.float32)
    pose = psamp.sample_bank(T(table), got)
    close(pose, rsamp.sample_bank(jnp.asarray(table), ref), atol=1e-5)
    # the port's gather form gives the same columns
    close(psamp.sample_frames(T(table.T.copy()), T(f0), T(f1), T(w0), T(w1)), pose, atol=1e-5)
    assert not torch.backends.cuda.matmul.allow_tf32


# -- time, mesh axis -----------------------------------------------------------------------

def test_time_helpers_and_world_axis_match_reference():
    from lumixengine_tpu.animation import animation as ra
    from lumixengine_tpu.parallel import mesh as rmesh
    from lumixengine_tpu_torch.animation import animation as pa
    from lumixengine_tpu_torch.parallel import mesh as pmesh

    assert pa.TIME_ONE_SECOND == ra.TIME_ONE_SECOND == 1 << 15
    for s in (0.0, 0.5, 1.0 / 3.0, 2.75, -1.2, 1e3):
        assert pa.time_from_seconds(s) == ra.time_from_seconds(s)
        assert type(pa.time_from_seconds(s)) is int
        t = ra.time_from_seconds(s)
        assert pa.time_to_seconds(t) == ra.time_to_seconds(t)
    assert pmesh.WORLD_AXIS == rmesh.WORLD_AXIS


# -- core/debug.py ---------------------------------------------------------------------------

@pytest.fixture
def traps_restored():
    yield
    debug.enable_floating_point_traps(False)


def test_floating_point_traps(traps_restored):
    """Off by default; on, the engine step raises FloatingPointError naming
    the field of its state that holds a NaN; off again, it does not."""
    from lumixengine_tpu_torch.models import demo_scenes as pds

    assert not debug.floating_point_traps_enabled()
    engine, world, *_ = pds.full_frame_world(64, 0, 4, 0)
    step = engine.build_step(world, "cpu")
    state = world.device_state("cpu")
    debug.enable_floating_point_traps()
    state = step(state, 1.0 / 60.0)                         # a clean step passes
    ph = state.modules["physics"]
    vel = ph.vel.clone()
    vel[1, 2] = float("nan")
    bad = state.replace(modules={**state.modules, "physics": ph.replace(vel=vel)})
    with pytest.raises(FloatingPointError, match=r"modules\.physics\.vel"):
        step(bad, 1.0 / 60.0)
    debug.enable_floating_point_traps(False)
    out = step(bad, 1.0 / 60.0)                             # off: the NaN passes unseen
    assert torch.isnan(out.modules["physics"].vel).any()
    with pytest.raises(FloatingPointError, match="local.pos"):
        debug.check_floating_point(bad.replace(local=bad.local.replace(
            pos=torch.full_like(bad.local.pos, float("nan")))))


# -- the JAX package's public surface --------------------------------------------------------

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "lumixengine_tpu", ROOT / "lumixengine_tpu_torch"
JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))
# JAX names the port keeps without a namesake (ROADMAP.md): each has a counterpart by
# another name, or is not code
KEPT = {"ops/culling.py": {"frustum_cull_jnp", "frustum_cull_pallas"},   # frustum_cull_plain, K1
        "ops/solver_pallas.py": None,                                   # ops/solver.py
        "renderer/model.py": {"ModelBank"},         # ModelRegistry.bake's host mirrors
        "ops/physics_big.py": {"pair_contacts_dynamic_note"},            # a docstring
        "ops/convex_ops.py": {"F32"},                                    # an alias
        "importers/instantiate.py": {"DEFAULT_DATA_DIRS"},               # explicit data_dirs
        "utils/cache.py": None}                                          # _build/ is the cache


def _top_level(path: Path, defs_only: bool):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif not defs_only and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_jax_name_has_a_counterpart(module):
    """An AST scan of the module's top-level public names (functions,
    classes, constants): each has a namesake in the port's module, but for
    the ones kept without a namesake."""
    port = PORT_PKG / module
    if module in KEPT and KEPT[module] is None:
        assert not port.exists(), module
        return
    assert port.exists(), module
    missing = _top_level(JAX_PKG / module, True) - _top_level(port, False) - KEPT.get(module, set())
    assert not missing, f"{module}: {sorted(missing)}"


# JAX class members the port keeps without a namesake ("module", "Class") -> names; each
# has a counterpart by another name, or nothing in the JAX package reads it
KEPT_MEMBERS = {
    ("renderer/render_module.py", "RendererSystem"): {"bank"},     # RendererSystem.bake
    ("script/lua_fastpath.py", "FastUpdate"): {"batched"},         # vmap's form; already batched
    ("physics/module.py", "PhysStatics"): {
        "incidence_a", "incidence_b",     # the jnp backend builds its incidences per frame
        "ctrl_radius", "ctrl_height",     # written, never read
        "veh_mask",                       # written, never read
        "veh_body",                       # read in the constructor only: a local there
    },
}
# JAX parameters the port keeps without a namesake ("module", "qualified name") -> names;
# each is a form of the JAX package (tracing, Pallas, its argument layout), not a function
KEPT_PARAMS = {
    ("engine/engine.py", "Engine.build_step"): {"jit", "donate"},          # the step is eager
    ("ops/culling.py", "frustum_cull"): {"frustum", "use_pallas"},         # planes; the device
    ("renderer/culling_system.py", "cull"): {"frustum", "use_pallas"},     # planes; the device
    ("renderer/pipeline.py", "prepare_view"): {"use_pallas"},              # the device decides
    ("renderer/pipeline.py", "cull_pass"): {"use_pallas"},                 # the device decides
    ("ops/physics_banded.py", "solve_contacts_banded_multi"): {"return_lams"},  # always returned
    ("ops/physics_big.py", "compact_pairs"): {"body_count"},     # a traced list's static bound
    ("ops/physics_ops.py", "heightfield_contacts"): {"terrain_bank",       # bank
                                                     "shape_np"},          # slot_mask
    ("ops/sampling.py", "frame_weights"): {"clip_offset", "clip_frames",   # statics
                                           "clip_fps", "clip_length"},
    ("ops/sampling.py", "sample_clips"): {"table"},                        # bank
    ("ops/sampling.py", "sample_root_motion"): {"root_table"},             # bank
    ("parallel/mesh.py", "build_sharded_step"): {"step_fn"},               # make_step
    ("parallel/mesh.py", "replicate_state"): {"perturb_key"},              # a torch.Generator
    ("renderer/particle_compiler.py", "CompiledEmitter.run_update"): {"cap"},   # shape
    ("renderer/particle_compiler.py", "CompiledEmitter.run_emit"): {"cap"},     # shape
    ("renderer/particle_compiler.py", "CompiledEmitter.run_output"): {"cap"},   # shape
}


def _class_members(cnode: ast.ClassDef):
    """The public names a class defines: methods, class attributes, dataclass
    fields, and the attributes its methods assign on self."""
    names = set()
    for node in cnode.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    for node in ast.walk(cnode):
        targets = (node.targets if isinstance(node, ast.Assign) else [node.target]
                   if isinstance(node, (ast.AnnAssign, ast.AugAssign)) else [])
        for t in targets:
            for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                if (isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name)
                        and e.value.id == "self"):
                    names.add(e.attr)
    return {n for n in names if not n.startswith("_")}


def _classes(path: Path):
    return {n.name: n for n in ast.parse(path.read_text()).body
            if isinstance(n, ast.ClassDef) and not n.name.startswith("_")}


def _port_module(module: str):
    import importlib

    return importlib.import_module("lumixengine_tpu_torch." + module[:-3].replace("/", "."))


def _port_members(cls):
    """Every name the port's class answers to: dir() of the class, and the
    attributes the methods of each class in its MRO (those in the port)
    assign on self."""
    import inspect

    names = set(dir(cls))
    for k in inspect.getmro(cls):
        src = inspect.getsourcefile(k) if k.__module__.startswith("lumixengine_tpu_torch") else None
        if src is not None and k.__name__ in _classes(Path(src)):
            names |= _class_members(_classes(Path(src))[k.__name__])
    return names


def _ported_modules():
    return [m for m in JAX_MODULES if not (m in KEPT and KEPT[m] is None)]


@pytest.mark.parametrize("module", _ported_modules())
def test_every_public_jax_class_member_has_a_counterpart(module):
    """An AST scan of each public JAX class of the module: every method,
    class attribute, dataclass field and attribute set on self has a
    namesake in the port's class of the same name (its bases included), but
    for the ones KEPT_MEMBERS keeps with a reason; each kept name is still
    missing, so the list does not go stale."""
    port = _port_module(module)
    for cname, cnode in _classes(JAX_PKG / module).items():
        if cname in KEPT.get(module, set()):
            continue
        assert hasattr(port, cname), f"{module}: class {cname}"
        gap = _class_members(cnode) - _port_members(getattr(port, cname))
        kept = KEPT_MEMBERS.get((module, cname), set())
        assert gap == kept, f"{module} {cname}: missing {sorted(gap - kept)}, kept but present " \
                            f"{sorted(kept - gap)}"


def _signatures(path: Path):
    """Public functions and public classes' methods (their __init__ too) of a
    module: qualified name (":fset" after a property's setter) -> parameter
    names, self and cls left out."""
    out = {}

    def params(fn):
        a = fn.args
        names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        names += [v.arg for v in (a.vararg, a.kwarg) if v is not None]
        return [n for n in names if n not in ("self", "cls")]

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            out[node.name] = params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and (not m.name.startswith("_") or m.name == "__init__")):
                    setter = any(isinstance(d, ast.Attribute) and d.attr == "setter"
                                 for d in m.decorator_list)
                    out[f"{node.name}.{m.name}" + (":fset" if setter else "")] = params(m)
    return out


@pytest.mark.parametrize("module", _ported_modules())
def test_every_jax_parameter_has_a_counterpart(module):
    """Each parameter of the module's public functions and methods is a
    parameter of the port's counterpart, but for the forms KEPT_PARAMS
    keeps with a reason; each kept name is still missing. A function the
    port lacks by name is the other scans' to report."""
    import inspect

    port = _port_module(module)
    for qualname, names in _signatures(JAX_PKG / module).items():
        path, _, accessor = qualname.partition(":")
        obj = port
        for part in path.split("."):
            obj = getattr(obj, part, None)
        if isinstance(obj, property):
            obj = getattr(obj, accessor or "fget")
            assert obj is not None, f"{module} {qualname}: the port's property has no setter"
        if obj is None:
            continue
        gap = set(names) - set(inspect.signature(obj).parameters)
        kept = KEPT_PARAMS.get((module, qualname), set())
        assert gap == kept, f"{module} {qualname}: missing {sorted(gap - kept)}, kept but " \
                            f"present {sorted(kept - gap)}"
