"""The hull debris level's own reference (``reference/banded_hulls.py``)
against the port at a small size of its own (100 hulls at 320 slots,
window 16, W=2: 12 stacks on the slab, 8 on the ground): the start and the
first frames each from its own state, then frames of the landed pile
stepped from the port's state with the warm-start carry live; and the check
it decides refuses the bfloat16 control and each planted fault: a state
unchanged, one hull moved 1 cm, the carry zeroed, the SAT without its
centre-line axis."""
import math
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import check, spec, tree
from benchmark.harness import scene as scenes
from benchmark.reference import banded_hulls as bh

ARGS = {"num_hulls": 100, "capacity": 320, "window": 16}
SEED = 2 ** 31 + 11
WORLDS = 2
LANDED = 30           # frames until the lowest hulls have sat on the slab and the ground a few frames
DT = 1 / 60
# the reference sums each contact's impulse into its two bodies by index,
# the port over shifted views of its rank space: the same float32
# operations in another order, so velocities part by rounding alone (10
# Jacobi passes over a pile of 100); every decision before the solve
# (bounds, sort keys, pair tests, the SAT's axes, depths, the field's
# samples) is computed by the same operations on the same operands and must
# come out equal
ATOL = {"body": 1e-5, "carry": 1e-5, "transform": 1e-5, "clock": 0.0, "decisions": 0}


def hull_cell(worlds: int = WORLDS) -> spec.Cell:
    cell = spec.cell("hulls.debris10k")
    cell.config = dict(cell.config, args=dict(ARGS))
    cell.traffic = dict(cell.traffic, worlds=worlds)
    return cell


def assert_close(got, want, margins, what):
    gaps = check.world_gaps(got, want, margins, bh.GROUPS, bh.EXACT)
    for group, g in gaps.items():
        assert float(g.max()) <= ATOL[group], (what, group, float(g.max()))
    return gaps


@pytest.fixture(scope="module")
def landed():
    """The program's run to the pile: (cell, step, readings with start and
    first, the state LANDED frames after the warm frames)."""
    cell = hull_cell()
    _scene, step, state, got = cells.set_up(cell, SEED, "cpu")
    for _ in range(LANDED):
        state = step(state, DT)
    return cell, step, got, state


def test_the_reference_follows_the_port(landed):
    cell, step, got, state = landed
    ref = check.Reference(cell.config, SEED, "cpu", cell.bench_dir)
    start = ref.start(WORLDS, SEED, got.rows)
    assert_close(got.start, start, None, "start")
    first, margins = ref.frame(start, DT)
    assert_close(got.first, first, margins, "first")
    flat = tree.flatten(state)
    assert int(flat[bh.COUNTERS[0]].min()) > 50 and int((flat[bh.CARRY[2]] >= 0).sum()) > 0
    glam = flat[bh.CARRY[1]].abs()                      # [W, 3, 4 + V + V, NB]
    plane, field = glam[:, :, 4:4 + bh.V_CAP], glam[:, :, 4 + bh.V_CAP:]
    assert float(flat[bh.CARRY[0]].abs().max()) > 0 and float(plane.max()) > 0
    assert float(field.max()) > 0 and float(glam[:, :, :4].max()) == 0
    for frame in range(3):
        before = tree.flatten(state)
        state = step(state, DT)
        want, margins = ref.frame(before, DT)
        gaps = assert_close(tree.flatten(state), want, margins, f"frame {frame}")
        assert set(gaps) == set(ATOL)
        assert (tree.flatten(state)[bh.COUNTERS[1]] == 0).all()


def judged(cell, step, got, state, fault=None, lower=False):
    """`correct` of a window whose last frame is `fault(step)` from `state`."""
    last = (fault or (lambda s: s))(step)(state, DT)
    got.prev, got.last = tree.flatten(state), tree.flatten(last)
    numbers, _n, failed = cells.judge(cell, got, SEED, "cpu", lower=lower)
    limits = cell.config["limits"]
    return failed == 0 and all(v <= limits[k] for k, v in numbers.items()), numbers


def unchanged(step):
    return lambda state, dt: state


def moved(step):
    """One hull 1 cm up, in its body and its entity (entity 2)."""
    def run(state, dt):
        out = step(state, dt)
        ph = out.modules["physics"]
        pos, local = ph.pos.clone(), out.local.pos.clone()
        pos[:, 1, 0] += 0.01
        local[:, 1, 2] += 0.01
        return out.replace(local=out.local.replace(pos=local),
                           modules={**out.modules, "physics": ph.replace(pos=pos)})
    return run


def carry_zeroed(step):
    def run(state, dt):
        out = step(state, dt)
        ph = out.modules["physics"]
        ph = ph.replace(sap_lam=torch.zeros_like(ph.sap_lam),
                        sap_glam=torch.zeros_like(ph.sap_glam))
        return out.replace(modules={**out.modules, "physics": ph})
    return run


def without_centre_line(step):
    """The hull pairs' SAT with its candidate axes cut to the two hulls'
    face normals: inside convex_ops.polytope_pair_contacts_from_data the
    one concatenation of three parts is the candidates' (a's faces, b's,
    the centre line), and it keeps the first two."""
    from lumixengine_tpu_torch.ops import convex_ops as CV

    sat = CV.polytope_pair_contacts_from_data

    class FacesOnly:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def cat(parts, dim=0):
            return torch.cat(parts[:2] if len(parts) == 3 else parts, dim=dim)

    def faulty(*args, **kwargs):
        CV.torch = FacesOnly()
        try:
            return sat(*args, **kwargs)
        finally:
            CV.torch = torch

    def run(state, dt):
        CV.polytope_pair_contacts_from_data = faulty
        try:
            return step(state, dt)
        finally:
            CV.polytope_pair_contacts_from_data = sat
    return run


def test_a_sound_window_is_correct(landed):
    assert judged(*landed)[0]


@pytest.mark.parametrize("fault", [unchanged, moved, carry_zeroed, without_centre_line])
def test_a_planted_fault_is_not_correct(landed, fault):
    assert not judged(*landed, fault=fault)[0]


def test_the_centre_line_decides_some_pairs(landed):
    """The SAT without its centre line changes some contact of the landed
    pile: the fault above plants a change the check can see."""
    _cell, step, _got, state = landed
    a, b = step(state, DT), without_centre_line(step)(state, DT)
    assert not torch.equal(a.modules["physics"].vel, b.modules["physics"].vel)


def test_the_control_is_not_correct(landed):
    """The reference in bfloat16 in the program's place fails at least one
    number."""
    correct, numbers = judged(*landed, lower=True)
    limits = landed[0].config["limits"]
    assert not correct
    assert any(math.isnan(v) or v > limits[k] for k, v in numbers.items())


def test_the_reference_loads_nothing_of_the_port():
    """banded_hulls built and stepped in a fresh process: no module of the
    port or of the JAX side is loaded."""
    config = spec.load_json(os.path.join(spec.BENCH_DIR, "configs", "hull_debris.json"))
    code = (
        f"import sys; sys.path.insert(0, {spec.ROOT!r})\n"
        "import torch\n"
        "from benchmark.reference import banded_hulls as bh\n"
        f"cfg = {{'args': {dict(ARGS, num_hulls=20)!r}, 'sdf': {config['sdf']!r}}}\n"
        "m = bh.Model(bh.build(cfg, 3), 'cpu')\n"
        "m.frame(m.start(2, torch.Generator().manual_seed(3)), 1 / 60)\n"
        "print(sorted({n.split('.')[0] for n in sys.modules} & {'lumixengine_tpu_torch', "
        "'lumixengine_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_scene_is_the_same_on_both_sides():
    """The reference's start positions, hulls' bounds and camera equal the
    port's scene's."""
    config = dict(hull_cell().config)
    prog = scenes.build(config, SEED, "cpu")
    scene = bh.build(config, scenes.seed_of(SEED))
    pm = prog.world.modules["physics"]
    st = pm.device_state("cpu")
    n = ARGS["num_hulls"]
    assert torch.equal(st.pos[:, :n], torch.as_tensor(scene.starts.T))
    radius = torch.tensor([h.radius for h in scene.hulls], dtype=torch.float32)
    assert torch.equal(torch.as_tensor(pm.statics().radius[:n]), radius)
    cam = prog.world.device_state("cpu").local.pos[:, 0]
    assert torch.equal(cam, torch.tensor(scene.camera[0], dtype=torch.float32))


def test_the_sat_bytes():
    """The SAT's bytes at the cell's size: 4 worlds, 4 sweeps of 10,240
    bodies, k = 4 by K = 24 slots a body, hulls of 16 vertices and 12 axes:
    376 B of tables a body and 29 B of grids a slot, each sweep."""
    from benchmark.harness import hull_counts

    assert hull_counts.sat_bytes(4, 10240, 4, 4, 24, 16, 12) == 16 * 10240 * (376 + 96 * 29)
    assert hull_counts.sat_bytes(1, 1, 1, 1, 1, 0, 0) == 40 + 29


def test_the_readers_read_the_run(landed):
    """Off the card the span readers give nothing; the counter's reader gives
    the worlds' mean of hull_active, and nothing where the state lacks it."""
    from types import SimpleNamespace

    _cell, _step, _got, state = landed
    run = SimpleNamespace(on_card=False, state=state)
    for name in ("hulls.sat_ms", "hulls.sdf_ms", "hulls.ground_ms", "hulls.sat_roofline"):
        assert spec.reader(name).read(run) is None
    counters = state.modules["physics"].counters
    assert spec.reader("hulls.active_pairs").read(run) == float(
        counters["hull_active"].double().mean())
    ph = state.modules["physics"]
    bare = {k: v for k, v in counters.items() if k != "hull_active"}
    run.state = state.replace(modules={**state.modules, "physics": ph.replace(counters=bare)})
    assert spec.reader("hulls.active_pairs").read(run) is None
