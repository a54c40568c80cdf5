"""Core math, transforms, frustum builders and hierarchy propagation of the
port against lumixengine_tpu.core / ops.hierarchy on random inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lumixengine_tpu.core import geometry as rgeom
from lumixengine_tpu.core import math as rlm
from lumixengine_tpu.core import transform as rxf
from lumixengine_tpu.ops import hierarchy as rhier
from lumixengine_tpu_torch.core import geometry as geom
from lumixengine_tpu_torch.core import math as lm
from lumixengine_tpu_torch.core import transform as xf
from lumixengine_tpu_torch.ops import hierarchy as hier
from test_torch_bridge import port_world

torch.set_num_threads(1)

ATOL = 1e-6


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _unit_quats(rng, n, axis):
    q = _rand(rng, 4, n) if axis == -2 else _rand(rng, n, 4)
    return q / np.linalg.norm(q, axis=axis, keepdims=True)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("fn", ["cross", "dot", "normalize"])
def test_vector_ops(fn, axis):
    rng = np.random.default_rng(0)
    shape = (3, 257) if axis == -2 else (257, 3)
    a, b = _rand(rng, *shape), _rand(rng, *shape)
    if fn == "normalize":
        _close(lm.normalize(torch.tensor(a), axis=axis), rlm.normalize(jnp.asarray(a), axis=axis))
    else:
        _close(getattr(lm, fn)(torch.tensor(a), torch.tensor(b), axis=axis),
               getattr(rlm, fn)(jnp.asarray(a), jnp.asarray(b), axis=axis))


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("fn", ["quat_mul", "quat_conjugate", "quat_normalize", "quat_rotate"])
def test_quaternion_ops(fn, axis):
    rng = np.random.default_rng(1)
    q, r = _unit_quats(rng, 300, axis), _unit_quats(rng, 300, axis)
    v = _rand(rng, 3, 300) if axis == -2 else _rand(rng, 300, 3)
    if fn == "quat_mul":
        args = (q, r)
    elif fn == "quat_rotate":
        args = (q, v)
    else:
        args = (q * 3.0,)
    _close(getattr(lm, fn)(*(torch.tensor(x) for x in args), axis=axis),
           getattr(rlm, fn)(*(jnp.asarray(x) for x in args), axis=axis))


def test_quat_to_mat3():
    q = _unit_quats(np.random.default_rng(2), 64, -1)
    _close(lm.quat_to_mat3(torch.tensor(q)), rlm.quat_to_mat3(jnp.asarray(q)))


def _transforms(rng, n):
    pos = _rand(rng, 3, n)
    rot = _unit_quats(rng, n, -2)
    scale = rng.uniform(0.5, 2.0, (3, n)).astype(np.float32)
    return (xf.Transform(torch.tensor(pos), torch.tensor(rot), torch.tensor(scale)),
            rxf.Transform(pos=jnp.asarray(pos), rot=jnp.asarray(rot), scale=jnp.asarray(scale)))


def _close_xf(got, ref, atol=ATOL):
    for f in ("pos", "rot", "scale"):
        _close(getattr(got, f), getattr(ref, f), atol)


def test_compose():
    rng = np.random.default_rng(3)
    (pa, ra), (pb, rb) = _transforms(rng, 200), _transforms(rng, 200)
    _close_xf(xf.compose(pa, pb), rxf.compose(ra, rb))


def test_take_and_where():
    rng = np.random.default_rng(4)
    (pa, ra), (pb, rb) = _transforms(rng, 50), _transforms(rng, 50)
    idx = rng.integers(0, 50, 30)
    _close_xf(xf.take(pa, torch.tensor(idx)), rxf.take(ra, jnp.asarray(idx)), 0.0)
    mask = rng.random(50) < 0.5
    _close_xf(xf.where(torch.tensor(mask), pa, pb), rxf.where(jnp.asarray(mask), ra, rb), 0.0)


def _camera(rng):
    pos = _rand(rng, 3)
    rot = _unit_quats(rng, 1, -1)[0]
    return pos, rot


@pytest.mark.parametrize("seed", range(4))
def test_perspective_frustum(seed):
    rng = np.random.default_rng(seed)
    pos, rot = _camera(rng)
    fov, aspect = float(rng.uniform(0.5, 1.5)), float(rng.uniform(1.0, 2.0))
    got = geom.perspective_frustum(torch.tensor(pos), torch.tensor(rot), fov, aspect, 0.3, 2.0)
    ref = rgeom.perspective_frustum(jnp.asarray(pos), jnp.asarray(rot), fov, aspect, 0.3, 2.0)
    _close(got.planes, ref.planes)


@pytest.mark.parametrize("seed", range(4))
def test_ortho_frustum(seed):
    rng = np.random.default_rng(10 + seed)
    pos, rot = _camera(rng)
    got = geom.ortho_frustum(torch.tensor(pos), torch.tensor(rot), 3.0, 2.0, 0.1, 2.0)
    ref = rgeom.ortho_frustum(jnp.asarray(pos), jnp.asarray(rot), 3.0, 2.0, 0.1, 2.0)
    _close(got.planes, ref.planes)


def test_batched_frustum_matches_per_camera():
    """One camera per world along a batch axis gives each world's own planes."""
    rng = np.random.default_rng(20)
    cams = [_camera(rng) for _ in range(5)]
    fov = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    pos = torch.tensor(np.stack([c[0] for c in cams]))
    rot = torch.tensor(np.stack([c[1] for c in cams]))
    got = geom.perspective_frustum(pos, rot, torch.tensor(fov), 1.5, 0.3, 2.0).planes
    for i, (p, r) in enumerate(cams):
        ref = rgeom.perspective_frustum(jnp.asarray(p), jnp.asarray(r), fov[i], 1.5, 0.3, 2.0)
        _close(got[i], ref.planes)


def test_frustum_sphere_visible():
    rng = np.random.default_rng(5)
    pos, rot = _camera(rng)
    fr = geom.perspective_frustum(torch.tensor(pos), torch.tensor(rot), 1.2, 1.6, 0.3, 50.0)
    rfr = rgeom.perspective_frustum(jnp.asarray(pos), jnp.asarray(rot), 1.2, 1.6, 0.3, 50.0)
    centers = rng.uniform(-40, 40, (3, 4000)).astype(np.float32)
    radii = rng.uniform(0, 3, 4000).astype(np.float32)
    got = geom.frustum_sphere_visible(fr, torch.tensor(centers), torch.tensor(radii)).numpy()
    ref = np.asarray(rgeom.frustum_sphere_visible(rfr, jnp.asarray(centers), jnp.asarray(radii)))
    planes = np.asarray(rfr.planes)
    margin = (planes[:6, :3] @ centers + planes[:6, 3:]).min(axis=0) + radii
    off = got != ref
    assert 0 < ref.sum() < ref.size
    assert not np.any(off & (np.abs(margin) >= 1e-5))


def test_compute_levels_host():
    parent = np.full(200, -1, np.int32)
    rng = np.random.default_rng(6)
    for i in range(1, 200):
        if rng.random() < 0.6:
            parent[i] = rng.integers(0, i)
    lv, d = hier.compute_levels_host(parent)
    rlv, rd = rhier.compute_levels_host(parent)
    np.testing.assert_array_equal(lv, rlv)
    assert d == rd


def test_propagate_plan():
    """The slice world's plan over random locals, in both packages."""
    _e, world, _r, _p = port_world()
    plan = world.plan
    rplan = rhier.HierarchyPlan(plan.segments)
    rng = np.random.default_rng(7)
    n = world.capacity
    local, rlocal = _transforms(rng, n)
    local.pos = local.pos * 20.0
    rlocal = rlocal.replace(pos=rlocal.pos * 20.0)
    _close_xf(hier.propagate_plan(local, plan), rhier.propagate_plan(rlocal, rplan), 1e-5)
    # batched: the world axis in front
    lb = xf.Transform(*(torch.stack([t, t * 0.5]) for t in (local.pos, local.rot, local.scale)))
    got = hier.propagate_plan(lb, plan)
    ref = rhier.propagate_plan(rxf.Transform(pos=rlocal.pos * 0.5, rot=rlocal.rot * 0.5,
                                             scale=rlocal.scale * 0.5), rplan)
    _close_xf(xf.Transform(got.pos[1], got.rot[1], got.scale[1]), ref, 1e-5)
