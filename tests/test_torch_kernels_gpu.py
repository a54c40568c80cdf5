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


# -- the shapes the PhysicsModule's all-pairs branch gives K2 --------------------------

SANE_SPEED = 50.0    # m/s and rad/s


@pytest.mark.parametrize("nb,c", [
    (2, 4),        # d6_slider: one pair, no ground
    (4, 24),       # hinge_pendulum: six pairs, no ground
    (3, 24),       # stack3: ground slots and three pairs
    (20, 848),     # ground slots and the all-pairs limit of 192 pairs: 4 * NB + 768
])
@pytest.mark.parametrize("w", [1, 4096])
@pytest.mark.parametrize("active", [0.0, 0.5, 1.0])
def test_k2_all_pairs_shapes(cuda, nb, c, w, active):
    """Small worlds: a plan whose compact tier holds the whole world, a
    128-thread CTA for 4 slots, worlds whose act row is all zeros."""
    prob = _random_problem(cuda, w, nb, c, active, seed=nb + c + w)
    v, ang, dpos, ln, lt1, lt2 = _check_k2(prob)
    off = prob.act == 0
    for lam in (ln, lt1, lt2):
        assert bool((lam[off] == 0).all())
    if active == 0.0:
        assert torch.equal(v, prob.vel) and torch.equal(ang, prob.angvel)
        assert not dpos.any()


@pytest.mark.parametrize("name", ["bounce", "stack3", "drop27", "friction_slide",
                                  "capsule_stack", "hinge_pendulum", "d6_slider"])
def test_k2_on_the_golden_worlds(cuda, name):
    """The contact sets of the committed golden worlds, one world and 4096
    diverging ones, 90 steps in: K2 against its plain version. A capsule
    takes a sphere's inertia (as in the reference), and in a few of the
    perturbed capsule worlds the top capsule spins up to hundreds of rad/s
    (the JAX package does the same from the same states); there a float32
    ulp exceeds K2's absolute limit, so the check takes the worlds whose
    bodies move below SANE_SPEED before and after the solve, at least 95%
    of them (4,047 of 4,096 capsule worlds on an H100 80GB HBM3 at 700 W)."""
    import os

    import numpy as np

    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import solver as S
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    path = os.path.join(os.path.dirname(__file__), "data", f"golden_{name}.npz")
    engine, world, state, _slots = PS.golden_world(dict(np.load(path)), cuda)
    step = engine.build_step(world, cuda)
    pm = world.modules["physics"]
    for w in (1, 4096):
        s = replicate_state(state, w, torch.Generator(device=cuda).manual_seed(w))
        for _ in range(90):
            s = step(s, PS.DT)
        prob = pm.solver_problem(s, PS.DT)
        assert prob.act.shape[0] == w
        plain = S.solve_plain(prob, 10, 3)
        sane = torch.stack([t.abs().amax(dim=(1, 2)) for t in (prob.vel, prob.angvel, *plain[:2])]
                           ).amax(dim=0) < SANE_SPEED
        assert int(sane.sum()) >= 0.95 * w, int(sane.sum())
        _check_k2(S.ContactProblem(**{k: v if k == "inv_mass" else v[sane].contiguous()
                                      for k, v in prob.tensors().items()}))


def _demo_state_on_both(cuda, worlds=8):
    """The headless demo world (512 entities) replicated to `worlds` worlds,
    3 frames in on the card, and the same state copied to the CPU."""
    from lumixengine_tpu_torch.models.demo_scenes import headless_demo_world
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    engine, world, _r = headless_demo_world(512)
    rm = world.modules["renderer"]
    step = engine.build_step(world, cuda, extra=rm.cull_pass)
    s = replicate_state(world.device_state(cuda), worlds, torch.Generator(device=cuda).manual_seed(3))
    for _ in range(3):
        s = step(s, 1.0 / 60.0)
    return rm, s, s.to("cpu")


@pytest.mark.parametrize("sort_mode", [0, 1])
def test_prepare_view_on_the_card(cuda, sort_mode):
    """prepare_view launches K1 once; from the same state the card's view is
    the CPU's: masks, keys (a depth key may round apart within DEPTH_EPS of
    an integer), and the draw order and instance buffers wherever the keys
    agree."""
    from lumixengine_tpu_torch.ops import culling as cull
    from lumixengine_tpu_torch.renderer import pipeline

    rm, gpu, cpu = _demo_state_on_both(cuda)
    before = cull.frustum_cull_cuda.launches
    g = pipeline.prepare_view(gpu, rm, sort_mode=sort_mode)
    assert cull.frustum_cull_cuda.launches == before + 1
    c = pipeline.prepare_view(cpu, rm, sort_mode=sort_mode)
    assert torch.equal(g.visible.cpu(), c.visible) and torch.equal(g.lod.cpu(), c.lod)
    off = (g.sort_key.cpu() != c.sort_key) | (g.sort_key_lo.cpu() != c.sort_key_lo)
    assert not (off & (pipeline.depth_margins(cpu, rm) >= pipeline.DEPTH_EPS)).any()
    same = ~off.any(-1)
    for f in ("order", "instance_model", "instance_slot", "visible_count", "lights_visible"):
        assert torch.equal(getattr(g, f).cpu()[same], getattr(c, f)[same]), f
    torch.testing.assert_close(g.instance_pos.cpu()[same], c.instance_pos[same], rtol=0, atol=0)


def test_shadow_and_cluster_passes_on_the_card(cuda):
    """From the same state: the cascades within 1e-5 of their magnitude, the
    casters equal outside SHADOW_MARGIN of a plane, the cluster words equal
    outside CLUSTER_D2_EPS of a light's range and the lists equal where no
    test flipped."""
    import numpy as np

    from lumixengine_tpu_torch.renderer import clusters, shadows

    rm, gpu, cpu = _demo_state_on_both(cuda)
    light = (0.3, -1.0, 0.2)
    sg, sc = shadows.shadow_pass(gpu, rm, light), shadows.shadow_pass(cpu, rm, light)
    for f in ("splits", "center", "radius", "light_pos", "extent"):
        ref = getattr(sc, f)
        torch.testing.assert_close(getattr(sg, f).cpu(), ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))
    near = shadows.caster_margins(cpu, rm, sc, light).abs() < shadows.SHADOW_MARGIN
    assert not ((sg.casters.cpu() != sc.casters) & ~near).any()
    ig, ic = clusters.cluster_inputs(gpu, rm), clusters.cluster_inputs(cpu, rm)
    off = clusters.unpack_words(clusters._touch_words(*ig).cpu() ^ clusters._touch_words(*ic))
    assert not (off & (clusters.touch_margins(*ic) >= clusters.CLUSTER_D2_EPS)).any()
    lg, lc = clusters.fill_clusters(gpu, rm), clusters.fill_clusters(cpu, rm)
    same = ~off.any(-1)
    assert torch.equal(lg.lights.cpu()[same], lc.lights[same])
    assert int(lc.count.sum()) > 0
    words = np.random.default_rng(0).integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.int64)
    t = torch.as_tensor(words)
    assert torch.equal(clusters.popcount32(t.to(cuda)).cpu(), clusters.popcount32(t))


def test_bone_attachments_on_the_card(cuda):
    """A crowd of 4 with a bone attachment: one frame on the card and on the
    CPU from the same state, the attachment's transforms within 1e-5."""
    from lumixengine_tpu_torch.models.demo_scenes import skinned_crowd_world

    engine, world, _r, _a = skinned_crowd_world(4)
    an = world.modules["animation"]
    char = int(an.animables.entity[an.animables.entity >= 0][0])
    sword = world.create_entity()
    world.create_component(sword, "bone_attachment", parent_entity=char, bone=5,
                           offset_pos=(0.0, 0.2, 0.0))
    rm = world.modules["renderer"]
    state = world.device_state(cuda)
    g = engine.build_step(world, cuda, extra=rm.cull_pass)(state, 1.0 / 60.0)
    c = engine.build_step(world, "cpu", extra=rm.cull_pass)(state.to("cpu"), 1.0 / 60.0)
    slot = world.slot(sword)
    for xf in ("local", "world"):
        torch.testing.assert_close(getattr(g, xf).pos[:, slot].cpu(), getattr(c, xf).pos[:, slot],
                                   rtol=0, atol=1e-5)
    assert float((g.local.pos[:, slot].cpu() - state.local.pos[:, slot].cpu()).abs().max()) > 0


def _game_scene(kind, cuda, worlds, frames):
    """Game-content world `kind` (models/physics_scenes.py) replicated to
    `worlds` diverging worlds on the card, `frames` frames in with its host
    inputs."""
    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    sc = {"props": PS.props_world, "drive": PS.drive_world, "terrain": PS.terrain_world}[kind]()
    step = sc.engine.build_step(sc.world, cuda)
    s = replicate_state(PS.start_state(sc, cuda), worlds, torch.Generator(device=cuda).manual_seed(7))
    for f in range(frames):
        s = step(PS.scene_inputs(kind, sc, s, f), PS.DT)
    return sc, s


@pytest.mark.parametrize("kind,frames", [("props", 60), ("drive", 60), ("terrain", 70)])
@pytest.mark.parametrize("worlds", [1, 1024])
def test_k2_on_the_game_worlds(cuda, kind, frames, worlds):
    """K2 against its plain version on the contact sets of the props, drive
    and terrain worlds (hull pairs, hull ground, SDF and heightfield
    streams, instanced statics, the vehicle's chassis), a world and 1024
    diverging ones, after their bodies have landed."""
    from lumixengine_tpu_torch.models import physics_scenes as PS

    sc, s = _game_scene(kind, cuda, worlds, frames)
    prob = sc.world.modules["physics"].solver_problem(s, PS.DT)
    assert prob.act.shape[0] == worlds and int(prob.act.sum()) > 0
    _check_k2(prob)


def test_game_queries_on_the_card(cuda):
    """The drive world's raycasts and sweeps (64 a world, layer-filtered)
    and a raycast against every actor of the props world (hulls included),
    on the card against the CPU from the same state: hit flags and bodies
    equal, distances within 1e-4."""
    from lumixengine_tpu_torch.models import physics_scenes as PS

    sc, s = _game_scene("drive", cuda, 64, 40)
    offs, dirs = (torch.as_tensor(a) for a in PS.drive_rays())
    gpu = PS.drive_queries(sc, s, offs.to(cuda), dirs.to(cuda))
    cpu = PS.drive_queries(sc, s.to("cpu"), offs, dirs)
    props, ps = _game_scene("props", cuda, 8, 30)
    pm = props.world.modules["physics"]
    g = torch.Generator().manual_seed(9)
    origin = torch.rand((8, 32, 3), generator=g) * torch.tensor([80.0, 4.0, 6.0]) - torch.tensor(
        [4.0, -0.5, 3.0])
    d = torch.nn.functional.normalize(torch.randn((8, 32, 3), generator=g), dim=-1)
    gpu += (pm.raycast(ps.modules["physics"], origin.to(cuda), d.to(cuda)),)
    cpu += (pm.raycast(ps.to("cpu").modules["physics"], origin, d),)
    hits = 0
    for (hg, tg, ig), (hc, tc, ic) in zip(gpu, cpu):
        assert torch.equal(hg.cpu(), hc)
        assert torch.equal(ig.cpu()[hc], ic[hc])
        assert torch.allclose(tg.cpu()[hc], tc[hc], rtol=0, atol=1e-4)
        hits += int(hc.sum())
    assert hits > 0
