"""The hand-written kernels on the card against their plain versions. These
tests need a CUDA device and skip without one; on a machine without JAX run
them with ``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``
(the suite's conftest configures JAX)."""
import pytest
import torch

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _random_views(dev, w, seed):
    from lumixengine_tpu_torch.core import geometry as geom

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((w, 4), generator=g, device=dev)
    eye = torch.randn((w, 3), generator=g, device=dev) * 10.0
    return geom.perspective_frustum(eye, q / q.norm(dim=-1, keepdim=True), 1.2, 16 / 9, 0.3,
                                    80.0).planes.contiguous(), g


def test_k1_bit_exact(cuda):
    from lumixengine_tpu_torch.ops import culling as cull

    w, k = 64, 10240
    planes, g = _random_views(cuda, w, 0)
    centers = torch.rand((w, 3, k), generator=g, device=cuda) * 160.0 - 80.0
    # a quarter of the spheres exactly on plane 0 of their world, radius 0
    n, d = planes[:, 0, :3], planes[:, 0, 3]
    q = centers[:, :, : k // 4]
    centers[:, :, : k // 4] = q - n[:, :, None] * ((n[:, :, None] * q).sum(1, keepdim=True)
                                                   + d[:, None, None])
    radii = torch.rand((w, k), generator=g, device=cuda) * 3.0
    radii[:, : k // 4] = 0.0
    before = cull.frustum_cull_cuda.launches
    got = cull.frustum_cull(centers, radii, planes)
    assert cull.frustum_cull_cuda.launches == before + 1
    assert torch.equal(got, cull.frustum_cull_plain(centers, radii, planes))
    assert 0 < int(got.sum()) < got.numel()


def test_k1_refuses_bad_operands(cuda):
    from lumixengine_tpu_torch.ops import culling as cull

    c = torch.zeros((2, 3, 16), device=cuda)
    with pytest.raises(ValueError):
        cull.frustum_cull_cuda(c.double(), torch.zeros((2, 16), device=cuda),
                               torch.zeros((2, 8, 4), device=cuda))
    with pytest.raises(ValueError):
        cull.frustum_cull_cuda(c, torch.zeros((2, 16), device=cuda), torch.zeros((2, 6, 4), device=cuda))


def _settled_problems(dev, worlds=8, frames=200):
    from lumixengine_tpu_torch.models.demo_scenes import full_frame_world
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    engine, world, _r, _p = full_frame_world(2048, 0, 64, 0)
    step = engine.build_step(world, dev, extra=world.modules["renderer"].cull_pass)
    s = replicate_state(world.device_state(dev), worlds, torch.Generator(device=dev).manual_seed(0))
    for _ in range(frames):
        s = step(s, 1.0 / 60.0)
    pm = world.modules["physics"]
    ph = s.modules["physics"]
    i = torch.arange(ph.pos.shape[-1], device=dev)
    grid = torch.stack([(i % 4) * 0.95, 0.45 + (i // 16) * 0.95, ((i // 4) % 4) * 0.95]).float()
    piled = s.replace(modules={**s.modules, "physics": ph.replace(
        pos=grid.expand(ph.pos.shape).contiguous())})
    return [pm.solver_problem(s, 1.0 / 60.0), pm.solver_problem(piled, 1.0 / 60.0)]


def test_k2_matches_plain(cuda):
    from lumixengine_tpu_torch.ops import solver as S

    for prob in _settled_problems(cuda):
        assert int(prob.act.sum()) > 0
        before = S.solve_cuda.launches
        got = S.solve(prob, 10, 3)
        assert S.solve_cuda.launches == before + 1
        ref = S.solve_plain(prob, 10, 3)
        for a, b in zip(got, ref):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=0, atol=S.K2_PLAIN_ATOL)


def test_k2_limit_catches_planted_faults(cuda):
    """The plain version one iteration or one projection pass short misses
    K2's limit on these contacts, so a kernel with such a fault would fail."""
    from lumixengine_tpu_torch.ops import solver as S

    probs = _settled_problems(cuda)
    for its in ((9, 3), (10, 2)):
        errs = [max(float((a - b).abs().max())
                    for a, b in zip(S.solve_plain(p, *its), S.solve_plain(p, 10, 3)))
                for p in probs]
        assert max(errs) > S.K2_PLAIN_ATOL, (its, errs)


def test_k2_refuses_bad_operands(cuda):
    from lumixengine_tpu_torch.ops import solver as S

    prob = _settled_problems(cuda, worlds=1, frames=1)[0]
    bad = S.ContactProblem(**{**prob.tensors(), "body_a": prob.body_a.long()})
    with pytest.raises(ValueError, match="body_a"):
        S.solve_cuda(bad, 1, 1)
    wide = S.ContactProblem(**{**prob.tensors(), "inv_mass": prob.inv_mass[:-1]})
    with pytest.raises(ValueError, match="inv_mass"):
        S.solve_cuda(wide, 1, 1)
