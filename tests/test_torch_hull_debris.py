"""The convex-hull debris level (models/demo_scenes.hull_debris_world) on the
CPU: the port's frame against the benchmark's plain reference of it
(benchmark/reference/banded_hulls.py) at 64 hulls and W=2; the reference's
cooking and slab field against physics/cooking.py's; the banded polytope
SAT taken in chunks of partner ranks bit for bit equal to the whole window
at once; the hull stages' spans and the hull_active counter; the layout
helper both hull builders share."""
import numpy as np
import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import check, spec, tree
from benchmark.reference import banded_hulls as bh
from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.core import profiler
from lumixengine_tpu_torch.models import demo_scenes as DS
from lumixengine_tpu_torch.models import physics_scenes as PS
from lumixengine_tpu_torch.ops import convex_ops as CV
from lumixengine_tpu_torch.ops import physics_banded as PB
from lumixengine_tpu_torch.parallel import mesh
from lumixengine_tpu_torch.physics import cooking

torch.set_num_threads(1)

ARGS = {"num_hulls": 64, "capacity": 320, "window": 16}
SEED = 2 ** 33 + 5
WORLDS = 2
LANDED = 25          # frames until the stacks' lowest hulls sit on the slab
DT = 1 / 60
# the reference sums each contact's impulse into its two bodies by index,
# the port over shifted views of its rank space: the same float32
# operations in another order, so velocities part by rounding alone;
# every decision before the solve (bounds, sort keys, pair tests, the SAT's
# axes and manifold, the field's samples, depths) takes the same operations
# on the same operands, so decisions are equal and the clock exact
ATOL = {"body": 1e-5, "carry": 1e-5, "transform": 1e-5, "clock": 0.0, "decisions": 0}
SPANS = {"physics.banded_hulls": "physics.banded_grids", "physics.sdf_streams": "physics.contacts",
         "physics.hull_ground": "physics.contacts"}


def debris_cell() -> spec.Cell:
    cell = spec.cell("hulls.debris10k")
    cell.config = dict(cell.config, args=dict(ARGS))
    cell.traffic = dict(cell.traffic, worlds=WORLDS)
    return cell


@pytest.fixture(scope="module")
def landed():
    """The port's debris level at test size, LANDED frames after the warm
    frames: (cell, step, readings with start and first, state)."""
    cell = debris_cell()
    _scene, step, state, got = cells.set_up(cell, SEED, "cpu")
    for _ in range(LANDED):
        state = step(state, DT)
    return cell, step, got, state


def gaps_within(got, want, margins, what):
    gaps = check.world_gaps(got, want, margins, bh.GROUPS, bh.EXACT)
    assert set(gaps) == set(ATOL), what
    for group, g in gaps.items():
        assert float(g.max()) <= ATOL[group], (what, group, float(g.max()))


def test_the_port_follows_the_reference(landed):
    """The start, the first frame from each side's own start, then 3 frames
    of the landed pile each from the port's state: every group within its
    tolerance and every decision equal."""
    cell, step, got, state = landed
    ref = check.Reference(cell.config, SEED, "cpu", cell.bench_dir)
    start = ref.start(WORLDS, SEED, got.rows)
    gaps_within(got.start, start, None, "start")
    first, margins = ref.frame(start, DT)
    gaps_within(got.first, first, margins, "first")
    counters = state.modules["physics"].counters
    assert int(counters["hull_active"].min()) > 20
    for frame in range(3):
        before = tree.flatten(state)
        state = step(state, DT)
        want, margins = ref.frame(before, DT)
        gaps_within(tree.flatten(state), want, margins, f"frame {frame}")


def test_cooking_agrees_with_the_reference():
    """The reference's cooked hulls equal physics/cooking.py's on the seed's
    hulls and on clouds past the 16-vertex cap (vertices and axes to 1e-6,
    counts exactly), and its slab field equals the cooked grid to 1e-6."""
    clouds = [points for _p, points in PS.banded_pile(200, SEED)]
    rng = np.random.default_rng(5)
    sphere = rng.normal(size=(60, 3))
    clouds += [(sphere / np.linalg.norm(sphere, axis=1, keepdims=True) * 0.4).astype(np.float32),
               rng.uniform(-0.5, 0.5, (40, 3)).astype(np.float32)]
    for points in clouds:
        got, want = cooking.cook_convex(points), bh.cook(points)
        assert (got.n_verts, got.n_faces) == (want.n_verts, want.n_faces)
        np.testing.assert_allclose(got.verts, want.verts, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.axes, want.axes, rtol=0, atol=1e-6)
        assert abs(got.bound_radius - want.radius) <= 1e-6
        assert abs(got.volume - want.volume) <= 1e-9
        np.testing.assert_allclose(got.inertia_diag, want.inertia, rtol=1e-5, atol=0)
    assert max(cooking.cook_convex(c).n_verts for c in clouds) == 16
    sdf = spec.load_json(spec.find("configs", "hull_debris"))["sdf"]
    grid = cooking.cook_mesh_sdf(PS.box_mesh(*PS.SLAB), PS.BOX_MESH_T, resolution=24)
    assert list(grid.grid.shape) == sdf["dims"] and grid.cell == sdf["cell"]
    np.testing.assert_array_equal(grid.origin, np.asarray(sdf["origin"], np.float32))
    np.testing.assert_allclose(grid.grid, bh.slab_field(sdf), rtol=0, atol=1e-6)


def whole_window_sat(sp, sr, s_pv, s_pax, s_prad, K, k):
    """banded_polytope_grids as it stood before its chunks: every slot of the
    window through the SAT at once."""
    nb = sp.shape[-1]

    def bcast(x):
        return x.unsqueeze(-2).expand(x.shape[:-1] + (K, nb)).reshape(x.shape[:-1] + (K * nb,))

    def partner(x):
        return PB.banded_pair_data(x, K).reshape(x.shape[:-1] + (K * nb,))

    out = CV.polytope_pair_contacts_from_data(
        bcast(sp), bcast(sr), bcast(s_pv), bcast(s_pax), bcast(s_prad),
        partner(sp), partner(sr), partner(s_pv), partner(s_pax), partner(s_prad),
        points_per_pair=k)
    return tuple(x.reshape(x.shape[:-1] + (k, K, nb)) for x in out)


def stacked_hulls():
    """tests/test_torch_banded_sweeps_gpu.py's stacked hulls: the banded props
    level's 4 stacks of 5 hulls, the banded branch forced, window 7, W=2."""
    sc = PS.banded_props_level(hulls=20, capacity=24, neighbors=7, stack=5)
    pm = sc.world.modules["physics"]
    pm.broadphase = "banded"
    pm.invalidate_statics()
    return sc.engine.build_step(sc.world, "cpu"), PS.replicate_scene(
        PS.start_state(sc, "cpu"), WORLDS, 3)


def debris_level():
    engine, world, _r, _p = DS.hull_debris_world(**ARGS, seed=SEED)
    step = engine.build_step(world, "cpu", extra=world.modules["renderer"].cull_pass)
    return step, mesh.replicate_state(world.device_state("cpu"), WORLDS,
                                      torch.Generator().manual_seed(3))


def sat_calls(step, state, frames):
    """Every banded_polytope_grids call's arguments in the frame after
    `frames` frames."""
    for _ in range(frames):
        state = step(state, DT)
    calls, own = [], PB.banded_polytope_grids

    def record(*args):
        calls.append(args)
        return own(*args)

    PB.banded_polytope_grids = record
    try:
        step(state, DT)
    finally:
        PB.banded_polytope_grids = own
    return calls


@pytest.mark.parametrize("scene,frames", [(stacked_hulls, 40), (debris_level, 25)])
def test_the_chunked_sat_is_the_whole_window_bit_for_bit(scene, frames, monkeypatch):
    """Each sweep's SAT in chunks of 1, 2 and 3 partner ranks (HULL_SAT_BYTES
    set to hold that many) and of the whole window."""
    calls = sat_calls(*scene(), frames)
    assert len(calls) == 4
    active = 0
    for args in calls:
        sp, _sr, s_pv, s_pax, _rad, window, _k = args
        batch, v, f, nb = sp.shape[0], s_pv.shape[-2], s_pax.shape[-2], sp.shape[-1]
        want = whole_window_sat(*args)
        active += int(want[3].sum())
        for chunk in (1, 2, 3, window):
            monkeypatch.setattr(PB, "HULL_SAT_BYTES", chunk * 2 * 4 * batch * v * (2 * f + 1) * nb)
            assert PB.hull_sat_chunk(batch, v, f, nb, window) == chunk
            got = PB.banded_polytope_grids(*args)
            for g, w in zip(got, want):
                assert g.shape == w.shape and torch.equal(g, w), chunk
    assert active > 0


def test_the_step_does_not_depend_on_the_chunks(monkeypatch):
    """A frame of the debris level with the SAT one partner rank at a time
    and with the whole window at once: the same state bit for bit."""
    step, state = debris_level()
    for _ in range(22):
        state = step(state, DT)
    whole = bridge.state_to_numpy(step(state, DT))
    monkeypatch.setattr(PB, "HULL_SAT_BYTES", 1)
    assert PB.hull_sat_chunk(WORLDS, 16, 12, ARGS["capacity"], ARGS["window"]) == 1
    chunked = bridge.state_to_numpy(step(state, DT))
    assert whole.keys() == chunked.keys()
    for k in whole:
        np.testing.assert_array_equal(chunked[k], whole[k], err_msg=k)


def test_the_sat_chunk_rule():
    """Partner ranks a chunk: the most whose two vertex-by-axis products fit
    in HULL_SAT_BYTES (4 worlds of 10,240 hulls of 16 vertices and 12 axes:
    65.5 MB a rank each), at least 1, at most K."""
    per_rank = 2 * 4 * 4 * 16 * 25 * 10240
    assert PB.hull_sat_chunk(4, 16, 12, 10240, 24) == min(24, PB.HULL_SAT_BYTES // per_rank)
    assert PB.hull_sat_chunk(1, 16, 12, 64, 7) == 7
    assert PB.hull_sat_chunk(4096, 16, 12, 10240, 24) == 1


@pytest.fixture
def recorder():
    """The recorder on and not paused for the test, as it was after it."""
    was = profiler._enabled, profiler._paused
    profiler.enable(True)
    profiler.pause(False)
    yield
    profiler.clear()
    profiler.enable(was[0])
    profiler.pause(was[1])


def blocks_of(step, state):
    profiler.clear()
    step(state, DT)
    return profiler.blocks()


def test_the_hull_stages_record_their_spans(recorder):
    """One frame of the debris level records each hull span inside its
    parent; a box-drop frame records none of them."""
    step, state = debris_level()
    found = blocks_of(step, state)
    for name, parent in SPANS.items():
        mine = [(a, b) for n, a, b, _t in found if n == name]
        outer = [(a, b) for n, a, b, _t in found if n == parent]
        assert mine, name
        assert all(any(a0 <= a and b <= b0 for a0, b0 in outer) for a, b in mine), name
    assert len([n for n, *_ in found if n == "physics.banded_hulls"]) == 4
    engine, world, renderer, _p = DS.box_drop_world(64, 320, 16, seed=5)
    box_step = engine.build_step(world, "cpu", extra=world.modules["renderer"].cull_pass)
    box = mesh.replicate_state(world.device_state("cpu"), WORLDS, torch.Generator().manual_seed(3))
    names = {n for n, *_ in blocks_of(box_step, box)}
    assert "physics.banded_grids" in names and not names & set(SPANS)


def test_hull_active_counts_the_hull_pair_slots(landed):
    """The counter is the active pair slots over the sweeps (every body here
    is a hull); a world without hulls has no such counter."""
    _cell, step, _got, state = landed
    stages, own = [], PB.banded_sweeps

    def record(*args):
        out = own(*args)
        stages.append(out)
        return out

    PB.banded_sweeps = record
    try:
        out = step(state, DT)
    finally:
        PB.banded_sweeps = own
    (sweeps, _warm, _miss, n_active), = stages
    pairs = sum(torch.sum(sw["p_active"], dim=(-3, -2, -1)) for sw in sweeps).to(torch.int32)
    counters = out.modules["physics"].counters
    assert torch.equal(counters["hull_active"], pairs) and bool((pairs > 0).all())
    assert bool((counters["active_contacts"] > pairs).all())
    round_trip = bridge.state_from_numpy(bridge.state_to_numpy(out), "cpu")
    assert torch.equal(round_trip.modules["physics"].counters["hull_active"], pairs)
    _e, world, _r, _p = DS.box_drop_world(64, 320, 16, seed=5)
    assert "hull_active" not in world.modules["physics"].device_state("cpu").counters


def test_both_hull_builders_share_the_pile():
    """banded_props_level and hull_debris_world lay out banded_pile's hulls;
    the props level's scene is as it was (start positions, and hull 13's
    first vertex and counts, of seed 7 at 40 hulls)."""
    sc = PS.banded_props_level(hulls=40, capacity=64, seed=7)
    pm = sc.world.modules["physics"]
    pile = PS.banded_pile(40, 7)
    for i, (p, points) in enumerate(pile):
        e = int(pm.actors.entity[sc.slots[f"hull{i}"]])
        np.testing.assert_array_equal(sc.world.get_global_transform(e)[0],
                                      np.asarray(p, np.float32))
        np.testing.assert_array_equal(pm.hulls[i].verts, cooking.cook_convex(points).verts)
    pinned = {0: (-3.125, 1.7999999523162842, -3.200000047683716),
              13: (1.125, 4.349999904632568, -2.9800000190734863),
              39: (2.875, 5.199999809265137, -0.7599999904632568)}
    for i, p in pinned.items():
        e = int(pm.actors.entity[sc.slots[f"hull{i}"]])
        assert tuple(float(x) for x in sc.world.get_global_transform(e)[0]) == p
    assert pm.hulls[13].verts[0].tolist() == [0.18694870173931122, 0.31472399830818176,
                                              0.16332902014255524]
    assert (pm.hulls[13].n_verts, pm.hulls[13].n_faces) == (10, 12)
    _e, world, _r, _p = DS.hull_debris_world(40, 64, 7, seed=7)
    dm = world.modules["physics"]
    st = dm.device_state("cpu")
    np.testing.assert_array_equal(st.pos[:, :40].numpy(), np.asarray([p for p, _ in pile],
                                                                     np.float32).T)
    assert all(np.array_equal(h.verts, pm.hulls[i].verts) for i, h in enumerate(dm.hulls))
    assert dm.statics().banded is False and DS.hull_debris_world(40, 320, 7, seed=7)[1].modules[
        "physics"].statics().banded
