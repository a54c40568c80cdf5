"""The banded Jacobi kernel (csrc/banded_jacobi.cu,
ops/physics_banded.py::solve_contacts_banded_cuda) on the card against the
plain version on the same inputs: the PhysicsModule's banded solve of the
10k-box drop at W=4 after the lattice has landed (4 sweeps, K = 40, ground
grids, warm start), and the stand-alone banded step's small pile (1 sweep,
cold, with and without its ground grids). These tests need a CUDA device
and skip without one; run them with
``python -m pytest --noconftest -m gpu tests/test_torch_banded_jacobi_gpu.py``
(the suite's conftest configures JAX).

Tolerances: the kernel sums each body's impulses in another order than the
plain version (contact by contact, where the plain version sums whole slot
grids and their skewed scatter views), so velocities and lambdas differ by
rounding, compounded over the 10 passes of a pile: SOLVE_ATOL, on
velocities in m/s and lambdas in N s. The observed maximum is printed."""
import numpy as np
import pytest
import torch

from lumixengine_tpu_torch.ops import physics_banded as PB

pytestmark = pytest.mark.gpu

SOLVE_ATOL = 1e-4
DT = 1.0 / 60.0
LAND_FRAMES = 60          # the lattice, lifted 2 m, has landed and piles up (~40 frames)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _capture(fn, *args):
    """fn(*args) with the arguments of its first call of
    solve_contacts_banded_multi kept: (args, kwargs)."""
    seen = []
    plain = PB.solve_contacts_banded_multi

    def spy(*a, **kw):
        if not seen:
            seen.append((a, kw))
        return plain(*a, **kw)

    PB.solve_contacts_banded_multi = spy
    try:
        fn(*args)
    finally:
        PB.solve_contacts_banded_multi = plain
    assert seen, "the step did not reach solve_contacts_banded_multi"
    return seen[0]


@pytest.fixture(scope="module")
def box_drop_solve():
    """The PhysicsModule's banded solve operands on the 10k-box drop, W=4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lumixengine_tpu_torch.models.demo_scenes import box_drop_world
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    dev = torch.device("cuda", 0)
    engine, world, _, _ = box_drop_world(10_000, 10_240, 40, seed=5)
    step = engine.build_step(world, dev, extra=world.modules["renderer"].cull_pass)
    state = replicate_state(world.device_state(dev), 4, torch.Generator(device=dev).manual_seed(5))
    for _ in range(LAND_FRAMES):
        state = step(state, DT)
    return _capture(step, state, DT)


@pytest.fixture(scope="module")
def pile_solve():
    """The stand-alone banded step's solve operands: a 4-layer pile of 64
    boxes on the ground, each with a seeded velocity, one sweep, no warm
    start."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    nb = 64
    i = np.arange(nb)
    pos = np.stack([(i % 4) * 0.98, 0.49 + (i // 16) * 0.98, ((i // 4) % 4) * 0.98]).astype(np.float32)
    step = PB.make_banded_world_step(
        np.full(nb, 1, np.int64), np.full(nb, 0.5, np.float32), np.full((3, nb), 0.5, np.float32),
        np.ones(nb, bool), np.ones(nb, np.float32), np.full((3, nb), 6.0, np.float32),
        np.full(nb, 0.6, np.float32), np.zeros(nb, np.float32), neighbors=24, iterations=10)
    rot = torch.zeros((4, nb), device=dev)
    rot[3] = 1.0
    gen = torch.Generator().manual_seed(7)
    vel, ang = (0.3 * torch.randn((2, 3, nb), generator=gen)).to(dev)
    return _capture(step, torch.from_numpy(pos).to(dev), rot, vel, ang, torch.tensor(DT, device=dev))


def _without_ground(args, kwargs):
    sweeps = [{k: v for k, v in sw.items() if not k.startswith("g_")} for sw in args[5]]
    return args[:5] + (sweeps,) + args[6:], kwargs


def _solve_both(args, kwargs):
    """The kernel and the plain version on the same operands; checks the
    launch count against the kernel's plan."""
    sweeps, warm = args[5], kwargs.get("warm")
    its = kwargs.get("iterations", 8)
    n_warm = sum(1 for s, sw in enumerate(sweeps) if warm is not None and warm[s]
                 and (warm[s].get("p") is not None
                      or (warm[s].get("g") is not None and "g_active" in sw)))
    before = PB.solve_contacts_banded_cuda.launches
    got = PB.solve_contacts_banded_cuda(*args, **kwargs)
    launches = PB.solve_contacts_banded_cuda.launches - before
    assert launches == 2 * len(sweeps) + 3 + n_warm + its * len(sweeps), launches
    ref = PB.solve_contacts_banded_multi_plain(*args, **kwargs)
    return got, ref


def _check(got, ref, sweeps, label):
    """Within SOLVE_ATOL everywhere; the lambdas of inactive slots exactly 0.
    Returns the largest gap."""
    gaps = [float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).abs().max())]
    for s, (gl, rl) in enumerate(zip(got[2], ref[2])):
        for j, (x, y) in enumerate(zip(gl, rl)):
            assert x.shape == y.shape and x.device == y.device, (label, s, j)
            if x.numel():
                gaps.append(float((x - y).abs().max()))
            key = "p_active" if j >= 3 else "g_active"
            if key in sweeps[s]:
                inactive = ~sweeps[s][key].expand(x.shape)
                assert int(torch.count_nonzero(x[inactive])) == 0, (label, s, j)
    assert all(bool(torch.isfinite(t).all()) for t in got[:2])
    print(f"{label}: largest gap to the plain version {max(gaps):.3e} (limit {SOLVE_ATOL:g})")
    assert max(gaps) <= SOLVE_ATOL, (label, gaps)
    return max(gaps)


def test_box_drop_solve_matches_plain(cuda, box_drop_solve):
    args, kwargs = box_drop_solve
    sweeps = args[5]
    assert len(sweeps) == 4 and sweeps[0]["p_active"].shape[-2] == 40 and "g_active" in sweeps[0]
    assert kwargs.get("warm") is not None and args[0].shape[0] == 4
    n_active = sum(int(sw["p_active"].sum()) for sw in sweeps)
    assert n_active > 4 * 10_000, n_active
    got, ref = _solve_both(args, kwargs)
    _check(got, ref, sweeps, f"box drop W=4, {n_active} active pair slots")
    moved = float((ref[0] - args[0]).abs().max())
    assert moved > 0.1, moved


def test_box_drop_solve_is_bit_identical_run_to_run(cuda, box_drop_solve):
    args, kwargs = box_drop_solve
    first = PB.solve_contacts_banded_cuda(*args, **kwargs)
    second = PB.solve_contacts_banded_cuda(*args, **kwargs)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    for a, b in zip(first[2], second[2]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("ground", [True, False])
def test_small_pile_solve_matches_plain(cuda, pile_solve, ground):
    args, kwargs = pile_solve if ground else _without_ground(*pile_solve)
    assert len(args[5]) == 1 and kwargs.get("warm") is None
    got, ref = _solve_both(args, kwargs)
    _check(got, ref, args[5], f"small pile, 1 sweep, cold, ground {ground}")
    assert float((ref[0] - args[0]).abs().max()) > 0.1


def test_contacts_past_the_record_capacity(cuda, pile_solve, box_drop_solve, monkeypatch):
    """With no record capacity every contact's constants are recomputed
    where a pass uses them: the same results as with records."""
    for label, (args, kwargs) in (("small pile", pile_solve), ("box drop", box_drop_solve)):
        with_records = PB.solve_contacts_banded_cuda(*args, **kwargs)
        monkeypatch.setattr(PB, "BJ_RECORDS_PER_BODY", 0)
        got, ref = _solve_both(args, kwargs)
        monkeypatch.setattr(PB, "BJ_RECORDS_PER_BODY", 16)
        _check(got, ref, args[5], f"{label}, no records")
        assert torch.equal(got[0], with_records[0]) and torch.equal(got[1], with_records[1])


def test_the_wrapper_dispatches_and_refuses(cuda, pile_solve):
    """CUDA tensors go to the kernel; operands the kernel does not take
    raise (no fallback to the plain version)."""
    args, kwargs = pile_solve
    before = PB.solve_contacts_banded_cuda.launches
    PB.solve_contacts_banded_multi(*args, **kwargs)
    assert PB.solve_contacts_banded_cuda.launches > before
    bad = [dict(args[5][0], p_depth=args[5][0]["p_depth"].double())]
    with pytest.raises(ValueError, match="p_depth"):
        PB.solve_contacts_banded_multi(*args[:5], bad, *args[6:], **kwargs)
    bad = [dict(args[5][0], order=args[5][0]["order"].cpu())]
    with pytest.raises(ValueError, match="order"):
        PB.solve_contacts_banded_multi(*args[:5], bad, *args[6:], **kwargs)
