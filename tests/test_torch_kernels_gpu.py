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
    from lumixengine_tpu_torch.models.demo_scenes import full_frame_world, pile_bodies
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    engine, world, *_ = full_frame_world(2048, 0, 64, 0)
    step = engine.build_step(world, dev, extra=world.modules["renderer"].cull_pass)
    s = replicate_state(world.device_state(dev), worlds, torch.Generator(device=dev).manual_seed(0))
    for _ in range(frames):
        s = step(s, 1.0 / 60.0)
    pm = world.modules["physics"]
    return [pm.solver_problem(s, 1.0 / 60.0), pm.solver_problem(pile_bodies(s), 1.0 / 60.0)]


def _check_k2(prob, iterations=10, position_iterations=3):
    """One K2 launch against solve_plain at K2_PLAIN_ATOL; returns its outputs."""
    from lumixengine_tpu_torch.ops import solver as S

    before = S.solve_cuda.launches
    got = S.solve(prob, iterations, position_iterations)
    assert S.solve_cuda.launches == before + 1
    ref = S.solve_plain(prob, iterations, position_iterations)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=S.K2_PLAIN_ATOL)
    return got


def _random_problem(dev, w, nb, c, active, seed=0):
    """A contact set made with numpy from a seed: random bodies, a quarter of
    the slots against the ground, random points, normals and depths, the
    fraction `active` of the slots active; every slot's operands finite. The
    prologue turns it into K2's operands."""
    import numpy as np

    from lumixengine_tpu_torch.ops import physics_ops as P
    from lumixengine_tpu_torch.ops import solver as S

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    pos = rng.uniform(-2.0, 2.0, (w, 3, nb))
    ba = rng.integers(0, nb, (w, c))
    bb = rng.integers(-1, nb, (w, c))
    bb = np.where(bb == ba, -1, bb)
    bb[:, : c // 4] = -1
    point = np.take_along_axis(pos, np.broadcast_to(ba[:, None], (w, 3, c)), -1)
    point = point + rng.uniform(-0.5, 0.5, (w, 3, c))
    normal = rng.normal(size=(w, 3, c))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    contacts = P.Contacts(body_a=torch.tensor(ba, device=dev), body_b=torch.tensor(bb, device=dev),
                          point=f32(point), normal=f32(normal),
                          depth=f32(rng.uniform(-0.01, 0.05, (w, c))),
                          active=torch.tensor(rng.random((w, c)) < active, device=dev))
    warm = (f32(rng.uniform(0.0, 0.3, (w, c))), f32(rng.normal(0.0, 0.05, (w, c))),
            f32(rng.normal(0.0, 0.05, (w, c))))
    return S.prologue(f32(pos), f32(rng.normal(0.0, 0.5, (w, 3, nb))),
                      f32(rng.normal(0.0, 0.2, (w, 3, nb))), contacts,
                      f32(rng.uniform(0.5, 2.0, nb)), f32(rng.uniform(1.0, 6.0, (w, 3, nb))),
                      1.0 / 60.0, f32(rng.uniform(0.3, 0.8, (w, c))),
                      f32(rng.uniform(0.0, 0.3, (w, c))), baumgarte=0.0, warm_lambdas=warm)


def test_k2_matches_plain(cuda):
    for prob in _settled_problems(cuda):
        assert int(prob.act.sum()) > 0
        _check_k2(prob)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_k2_every_cluster_size(cuda, cluster):
    """Worlds with every slot active, more than either compact tier holds,
    at a shape for which the plan holds them in place on 1, 2, 4 or 8 CTAs,
    so the distributed-shared-memory reduction runs at every width; beside
    them a world with a twentieth of its slots active."""
    import numpy as np

    from lumixengine_tpu_torch.ops import solver as S

    nb, c = {1: (64, 1792), 2: (64, 3584), 4: (64, 7168), 8: (256, 7168)}[cluster]
    plan = S.k2_plan(nb, c)
    assert plan.cluster == cluster
    frac = np.array([1.0, 1.0, 1.0, 0.05])[:, None]
    prob = _random_problem(cuda, 4, nb, c, frac, seed=cluster)
    assert int((prob.act != 0).sum(-1)[:3].min()) > max(plan.caps)
    _check_k2(prob)


def test_k2_largest_module_shape(cuda):
    """full_frame_world(2048, 0, 256, 0) piled: NB=256, C=7168, the largest
    shape the pruned branch makes, on a cluster of 8 CTAs."""
    from lumixengine_tpu_torch.models.demo_scenes import full_frame_world, pile_bodies
    from lumixengine_tpu_torch.ops import solver as S
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    _e, world, _r, _a, _p = full_frame_world(2048, 0, 256, 0)
    pm = world.modules["physics"]
    s = replicate_state(world.device_state(cuda), 8, torch.Generator(device=cuda).manual_seed(0))
    prob = pm.solver_problem(pile_bodies(s), 1.0 / 60.0)
    assert tuple(prob.act.shape) == (8, 7168) and S.k2_plan(256, 7168).cluster == 8
    assert int(prob.act[:, 1024:].sum()) > 0
    _check_k2(prob)


@pytest.mark.parametrize("w,nb,c,active", [
    (1, 64, 1792, 0.2),     # one world
    (16, 64, 1300, 0.33),   # C no multiple of the block size
    (16, 64, 1792, 0.26),   # about the second compact tier's capacity (472) active
    (16, 64, 1792, 1.0),    # every slot active
    (16, 64, 1792, 0.0),    # every slot inactive
    (8, 32, 644, 0.5),      # a small world
    (4, 256, 7168, 0.3),    # the largest module shape, random contacts
])
def test_k2_synthetic(cuda, w, nb, c, active):
    """Random contact sets; the inactive slots hold random finite operands
    and must come out with zero lambdas. Worlds with more active slots than
    the compact kernel's capacity go to the in-place kernel (near the
    capacity some do, some do not)."""
    prob = _random_problem(cuda, w, nb, c, active, seed=w + nb + c)
    v, ang, dpos, ln, lt1, lt2 = _check_k2(prob)
    off = prob.act == 0
    for lam in (ln, lt1, lt2):
        assert bool((lam[off] == 0).all())
    if active == 0.0:
        assert torch.equal(v, prob.vel) and torch.equal(ang, prob.angvel)
        assert not dpos.any()


@pytest.mark.parametrize("its", [(0, 3), (10, 0), (0, 0), (1, 1)])
@pytest.mark.parametrize("active", [0.2, 1.0])
def test_k2_iteration_counts(cuda, its, active):
    """A fifth of the slots active (the compact kernel) and all of them (in
    place)."""
    prob = _random_problem(cuda, 8, 64, 1792, active, seed=7)
    _check_k2(prob, *its)


@pytest.mark.parametrize("lo,hi", [(37, 301), (0, 1), (1791, 1792), (900, 903), (5, 6)])
def test_k2_active_span(cuda, lo, hi):
    """The compact kernel reads the rows other than act and the warm-start
    lambdas only over the span of a world's active slots, on 16-byte bounds:
    spans that start and end off those bounds, one slot at either end, and
    worlds with one slot active or none beside them."""
    import numpy as np

    frac = np.zeros((4, 1792))
    frac[0, lo:hi] = 1.0
    frac[1, lo:hi] = 0.5
    frac[2, lo] = 1.0
    prob = _random_problem(cuda, 4, 64, 1792, frac, seed=lo + hi)
    na = (prob.act != 0).sum(-1)
    assert int(na[2]) == 1 and int(na[3]) == 0
    v, ang, dpos, ln, lt1, lt2 = _check_k2(prob)
    off = prob.act == 0
    for lam in (ln, lt1, lt2):
        assert bool((lam[off] == 0).all())


def test_k2_at_its_limit(cuda):
    """K2 runs at the largest C it states for NB=256 and raises one slot
    group beyond it, and for a C that is no multiple of 4."""
    from lumixengine_tpu_torch.ops import solver as S

    c = S.k2_max_c(256)
    _check_k2(_random_problem(cuda, 2, 256, c, 0.2, seed=3), 2, 1)
    before = S.solve_cuda.launches
    for bad in (c + 4, 1798):
        prob = _random_problem(cuda, 1, 256, bad, 0.2, seed=4)
        with pytest.raises(ValueError, match="K2"):
            S.solve_cuda(prob, 1, 1)
    assert S.solve_cuda.launches == before


def test_k2_tiers(cuda):
    """Worlds with few, some, many and all slots active in one launch: the
    two compact tiers, each for the worlds the one before left, and the
    in-place kernel for the rest."""
    import numpy as np

    from lumixengine_tpu_torch.ops import solver as S

    frac = np.array([0.05, 0.2, 0.5, 1.0] * 3)[:, None]
    prob = _random_problem(cuda, 12, 64, 1792, frac, seed=13)
    na = (prob.act != 0).sum(-1)
    caps = S.k2_plan(64, 1792).caps
    assert bool((na <= caps[0]).any() and ((na > caps[0]) & (na <= caps[1])).any()
                and (na > caps[1]).any())
    _check_k2(prob)


def test_k2_worklists_loop(cuda):
    """More worlds than one wave of the list-driven kernels holds, so their
    CTAs solve several worlds each in the same shared memory: 600 worlds for
    the second compact tier, 200 for the in-place kernel."""
    import numpy as np

    from lumixengine_tpu_torch.ops import solver as S

    frac = np.where(np.arange(800) < 600, 0.19, 1.0)[:, None]
    prob = _random_problem(cuda, 800, 64, 1792, frac, seed=17)
    na = (prob.act != 0).sum(-1)
    caps = S.k2_plan(64, 1792).caps
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert int(((na > caps[0]) & (na <= caps[1])).sum()) > 4 * sms   # one wave: 4 an SM
    assert int((na > caps[1]).sum()) > sms                          # one wave: 1 an SM
    _check_k2(prob)


def test_k2_is_deterministic(cuda):
    """Every body sums its contacts in a fixed order: two launches agree bit
    for bit, in the compact kernel, in place on one CTA per world and on a
    cluster of 4."""
    from lumixengine_tpu_torch.ops import solver as S

    for c, active in ((1792, 0.2), (1792, 1.0), (7168, 1.0)):
        prob = _random_problem(cuda, 8, 64, c, active, seed=11)
        a = S.solve_cuda(prob, 10, 3)
        b = S.solve_cuda(prob, 10, 3)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_k2_smem_agrees_with_plan(cuda):
    from lumixengine_tpu_torch.ops import native
    from lumixengine_tpu_torch.ops import solver as S

    lib = native.library()
    for nb, c in ((64, 1792), (256, 7168), (8, 4), (256, S.k2_max_c(256))):
        plan = S.k2_plan(nb, c)
        assert lib.lumix_solve_contacts_smem(0, nb, c, plan.share) == plan.smem
        for cap, smem in zip(plan.caps, plan.cap_smems):
            if cap:
                assert lib.lumix_solve_contacts_smem(1, nb, c, cap) == smem


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
