"""The banded contact stage's kernel (csrc/banded_grids.cu,
ops/physics_banded.py::banded_sweeps_cuda) on the card against the plain
version (banded_sweeps_plain) on the same CUDA operands: the PhysicsModule's
stage on the 10k-box drop at W=4 after the lattice has landed (4 sweeps,
K = 40, ground, warm start); a soup of spheres, boxes and capsules with
static bodies, unoccupied slots and a layer matrix that rules pairs out,
under sweep kinds 1, 2, 4 and 5, cold and warm (last frame's ranks 4 cm
away, so that pairs' ranks crossed), with and without its ground stream; a
world narrower than the window (NB < K + 1); and the banded props level's
stacked hulls, whose pairs take the polytope SAT's grids. These tests need a
CUDA device and skip without one; run them with
``python -m pytest --noconftest -m gpu tests/test_torch_banded_sweeps_gpu.py``
(the suite's conftest configures JAX).

Tolerances: the kernel runs the narrowphase in the plain version's order of
operations, op by op, so it should agree bit for bit; what is allowed: a
flag may differ only on a slot whose plain depth lies within DEPTH_TIE of 0;
an active slot's point, normal and depth within POINT_ATOL; where two
corners' plain depths tie within CORNER_TIE, a pair's points compared as a
set. Everything else (friction, restitution, the warm-start lambdas, the
ground grids, the certificate) is gathers and compares: exact. The counts
are exact up to the flags allowed to differ."""
import numpy as np
import pytest
import torch

from lumixengine_tpu_torch.ops import physics_banded as PB
from test_torch_banded_sweeps import stage_inputs

pytestmark = pytest.mark.gpu

DEPTH_TIE = 1e-5
POINT_ATOL = 1e-5
CORNER_TIE = 1e-6
DT = 1.0 / 60.0
LAND_FRAMES = 60          # the lattice, lifted 2 m, has landed and piles up (~40 frames)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _capture(fn, *args):
    """fn(*args) with the keyword arguments of its first banded_sweeps call
    kept."""
    seen = []
    stage = PB.banded_sweeps

    def spy(*a, **kw):
        if not seen:
            names = ("pos", "rot", "mn", "mx", "orders", "ranks", "col_keys", "shape", "radius",
                     "he", "dyn", "occ", "fric", "rest", "K", "k", "any_caps", "ground", "carry",
                     "layers", "hulls")
            seen.append(dict(zip(names, a), **kw))
        return stage(*a, **kw)

    PB.banded_sweeps = spy
    try:
        fn(*args)
    finally:
        PB.banded_sweeps = stage
    assert seen, "the step did not reach banded_sweeps"
    return seen[0]


@pytest.fixture(scope="module")
def box_drop_stage():
    """The PhysicsModule's stage operands on the 10k-box drop, W=4, after
    LAND_FRAMES frames on the card; with the stage's launches each frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lumixengine_tpu_torch.models.demo_scenes import box_drop_world
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    dev = torch.device("cuda", 0)
    engine, world, _, _ = box_drop_world(10_000, 10_240, 40, seed=5)
    step = engine.build_step(world, dev, extra=world.modules["renderer"].cull_pass)
    state = replicate_state(world.device_state(dev), 4, torch.Generator(device=dev).manual_seed(5))
    per_frame = []
    for _ in range(LAND_FRAMES):
        before = PB.banded_sweeps_cuda.launches
        state = step(state, DT)
        per_frame.append(PB.banded_sweeps_cuda.launches - before)
    return _capture(step, state, DT), per_frame


@pytest.fixture(scope="module")
def hull_stage():
    """The stage operands of the banded props level's 4 stacks of 5 hulls
    (the banded branch forced, window 7) at W=2 after 40 frames: pairs of
    hulls resting on hulls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lumixengine_tpu_torch.models import physics_scenes as PS

    dev = torch.device("cuda", 0)
    sc = PS.banded_props_level(hulls=20, capacity=24, neighbors=7, stack=5)
    pm = sc.world.modules["physics"]
    pm.broadphase = "banded"
    pm.invalidate_statics()
    step = sc.engine.build_step(sc.world, dev)
    state = PS.replicate_scene(PS.start_state(sc, dev), 2, 3)
    for _ in range(40):
        state = step(state, DT)
    return _capture(step, state, DT)


def _pair_as_set(kp, kd, rp, rd, rk_act, kk_act):
    """One pair's k slots compared as a set: each kernel point active in
    both is some plain active point, unless its depth ties the pair's
    shallowest plain depth (a corner past the k-th may take its place)."""
    shallow = float(rd[rk_act].min()) if rk_act.any() else 0.0
    for a in np.nonzero(kk_act & rk_act)[0]:
        near = np.abs(rp[:, rk_act] - kp[:, a:a + 1]).max(axis=0) <= POINT_ATOL
        if not near.any() and abs(float(kd[a]) - shallow) > CORNER_TIE:
            return False
    return True


def compare_stage(got, ref, label):
    """The kernel's stage against the plain version's: see the module's
    tolerances. Returns (flags that differ, active slots, largest gap on
    slots active in both)."""
    (gs, gw, gm, gn), (rs, rw, rm, rn) = got, ref
    assert torch.equal(gm, rm), (label, gm, rm)
    assert len(gs) == len(rs)
    flips, n_active, gap = 0, 0, 0.0
    own = torch.zeros_like(gn)
    for s, (a, b) in enumerate(zip(gs, rs)):
        assert a.keys() == b.keys() and a["order"] is b["order"], (label, s)
        for key in PB.PAIR_KEYS + PB.GROUND_KEYS:
            if key in a:
                assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype, (label, key)
        for key in ("p_fric", "p_rest") + PB.GROUND_KEYS:
            if key in a:
                assert torch.equal(a[key], b[key]), (label, s, key)
        ka, ra = a["p_active"], b["p_active"]
        diff = ka != ra
        near = b["p_depth"].abs() <= DEPTH_TIE
        assert not bool((diff & ~near).any()), (label, s, "flags differ away from depth 0",
                                                int((diff & ~near).sum()))
        flips += int(diff.sum())
        n_active += int(ka.sum())
        own = own + ka.sum(dim=(-3, -2, -1)).to(own.dtype)
        if "g_active" in a:
            own = own + a["g_active"].sum(dim=(-2, -1)).to(own.dtype)
        both = ka & ra
        err = torch.maximum((a["p_point"] - b["p_point"]).abs().amax(dim=-4),
                            (a["p_normal"] - b["p_normal"]).abs().amax(dim=-4))
        err = torch.maximum(err, (a["p_depth"] - b["p_depth"]).abs())
        err = torch.where(both, err, 0.0)
        gap = max(gap, float(err.max()) if err.numel() else 0.0)
        bad_pairs = (err > POINT_ATOL).any(dim=-3).nonzero().tolist()
        assert len(bad_pairs) <= 64, (label, s, len(bad_pairs))
        for idx in bad_pairs:
            *w, d, i = idx
            sel = tuple(w) + (slice(None), d, i)
            rd, kd = b["p_depth"][sel].cpu().numpy(), a["p_depth"][sel].cpu().numpy()
            srt = np.sort(rd)
            assert np.any(np.diff(srt) <= CORNER_TIE) or np.any(
                np.abs(kd - srt[0]) <= CORNER_TIE), (label, s, idx, rd, kd)
            pts = tuple(w) + (slice(None), slice(None), d, i)
            assert _pair_as_set(a["p_point"][pts].cpu().numpy(), kd,
                                b["p_point"][pts].cpu().numpy(), rd,
                                ra[sel].cpu().numpy(), ka[sel].cpu().numpy()), (label, s, idx)
    assert torch.equal(gn, own), (label, gn, own)
    assert int((gn - rn).abs().sum()) <= flips, (label, gn, rn, flips)
    assert (gw is None) == (rw is None)
    for s, (a, b) in enumerate(zip(gw or (), rw or ())):
        assert a.keys() == b.keys()
        for key in a:
            for j, (x, y) in enumerate(zip(a[key], b[key])):
                assert x.shape == y.shape and torch.equal(x, y), (label, s, key, j)
    print(f"{label}: {n_active} active slots, {flips} flags at a depth tie, largest gap "
          f"{gap:.3e} (limit {POINT_ATOL:g})")
    return flips, n_active, gap


def _both(args):
    """The kernel and the plain version on the same operands; checks the
    launch count (one a sweep)."""
    before = PB.banded_sweeps_cuda.launches
    got = PB.banded_sweeps_cuda(**args)
    assert PB.banded_sweeps_cuda.launches - before == len(args["orders"])
    return got, PB.banded_sweeps_plain(**args)


def test_box_drop_stage_matches_plain(cuda, box_drop_stage):
    args, per_frame = box_drop_stage
    assert set(per_frame) == {4}, per_frame
    assert len(args["orders"]) == 4 and args["K"] == 40 and args["pos"].shape[0] == 4
    assert args["carry"] is not None and args["ground"] is not None
    got, ref = _both(args)
    flips, n_active, _ = compare_stage(got, ref, "box drop W=4")
    assert n_active > 4 * 10_000, n_active
    again = PB.banded_sweeps_cuda(**args)
    for a, b in zip(got[0], again[0]):
        assert all(torch.equal(a[key], b[key]) for key in PB.PAIR_KEYS + PB.GROUND_KEYS
                   if key in a)
    assert torch.equal(got[3], again[3])


SOUPS = {f"sweeps{n}_warm": dict(n_sweeps=n, warm=True, layers=True, batch=(2,))
         for n in (1, 2, 4, 5)}
SOUPS.update(sweeps4_cold_no_ground=dict(ground=False, batch=(3,)),
             sweeps5_cold=dict(n_sweeps=5, layers=True),
             sweeps4_no_capsules=dict(caps=False, warm=True, seed=1),
             narrow_world=dict(nb=8, window=10, warm=True, layers=True))


@pytest.mark.parametrize("case", list(SOUPS))
def test_soup_stage_matches_plain(cuda, case):
    args = stage_inputs(device=cuda, **SOUPS[case])
    got, ref = _both(args)
    _flips, n_active, _ = compare_stage(got, ref, case)
    assert n_active > (0 if case == "narrow_world" else 20), n_active
    if args["carry"] is not None:
        assert any(bool((w["p"][2] < 0).any()) for w in got[1]), "no pair's ranks crossed"


def test_hull_stage_matches_plain(cuda, hull_stage):
    assert hull_stage["hulls"] is not None and hull_stage["layers"] is not None
    got, ref = _both(hull_stage)
    _flips, n_active, _ = compare_stage(got, ref, "banded props, 4 stacks of 5 hulls")
    assert n_active > 0


def test_the_stage_dispatches_and_refuses(cuda):
    """CUDA float32 tensors go to the kernel; operands it does not take
    raise (no fallback to the plain version)."""
    args = stage_inputs(device=cuda, warm=True)
    before = PB.banded_sweeps_cuda.launches
    PB.banded_sweeps(**args)
    assert PB.banded_sweeps_cuda.launches == before + 4
    with pytest.raises(ValueError, match="radius"):
        PB.banded_sweeps(**dict(args, radius=args["radius"].cpu()))
    with pytest.raises(ValueError, match="pos"):
        PB.banded_sweeps(**dict(args, pos=args["pos"].double()))
    with pytest.raises(ValueError, match="order"):
        PB.banded_sweeps(**dict(args, orders=[o.cpu() for o in args["orders"]]))
    assert PB.banded_sweeps_cuda.launches == before + 4
