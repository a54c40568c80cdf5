"""The box drop's own reference (``reference/banded_boxes.py``) against the
port at a small size of its own (64 boxes at 320 slots, window 16, W=2):
the start and the first frames each from its own state, then frames of the
landed pile stepped from the port's state with the warm-start carry live;
and the check it decides refuses the bfloat16 control and each planted
fault: a state unchanged, one box moved 1 cm, the carry zeroed, a window
narrowed until the certificate counts drops."""
import contextlib
import math
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import check, spec, tree
from benchmark.harness import scene as scenes
from benchmark.reference import banded_boxes as bb

ARGS = {"num_bodies": 64, "capacity": 320, "window": 16}
SEED = 2 ** 31 + 11
WORLDS = 2
LANDED = 45           # frames until the lowest layer has sat on the ground for ~10 frames
DT = 1 / 60
# the reference sums each contact's impulse into its two bodies by index,
# the port over shifted views of its rank space: the same float32
# operations in another order, so velocities part by rounding alone
# (10 Jacobi passes over a pile of 64); every decision before the solve
# (bounds, sort keys, pair tests, depths) is computed by the same
# operations on the same operands and must come out equal
ATOL = {"body": 1e-5, "carry": 1e-5, "transform": 1e-5, "clock": 0.0, "decisions": 0}


def box_cell(worlds: int = WORLDS, window: int = ARGS["window"]) -> spec.Cell:
    cell = spec.cell("boxes.drop10k")
    cell.config = dict(cell.config, args=dict(ARGS, window=window))
    cell.traffic = dict(cell.traffic, worlds=worlds)
    return cell


def assert_close(got, want, margins, what):
    gaps = check.world_gaps(got, want, margins, bb.GROUPS, bb.EXACT)
    for group, g in gaps.items():
        assert float(g.max()) <= ATOL[group], (what, group, float(g.max()))
    return gaps


@pytest.fixture(scope="module")
def landed():
    """The program's run to the pile: (cell, step, readings with start and
    first, the state LANDED frames after the warm frames)."""
    cell = box_cell()
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
    assert int(flat[bb.COUNTERS[0]].min()) > 50 and int((flat[bb.CARRY[2]] >= 0).sum()) > 0
    assert float(flat[bb.CARRY[0]].abs().max()) > 0 and float(flat[bb.CARRY[1]].abs().max()) > 0
    for frame in range(3):
        before = tree.flatten(state)
        state = step(state, DT)
        want, margins = ref.frame(before, DT)
        gaps = assert_close(tree.flatten(state), want, margins, f"frame {frame}")
        assert set(gaps) == set(ATOL)
        assert (tree.flatten(state)[bb.COUNTERS[1]] == 0).all()


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
    """One box 1 cm up, in its body and its entity."""
    def run(state, dt):
        out = step(state, dt)
        ph = out.modules["physics"]
        pos, local = ph.pos.clone(), out.local.pos.clone()
        pos[:, 1, 0] += 0.01
        local[:, 1, 1] += 0.01
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


NARROW = 2


@contextlib.contextmanager
def narrowed(window: int):
    """The banded branch with its pair window cut to `window` inside the
    configured one (the grids keep their shape) and its certificate
    counted at `window`."""
    from lumixengine_tpu_torch.ops import physics_banded as PBD

    grids, cert = PBD.banded_pair_grids, PBD.column_window_miss

    def cut_grids(*args, **kwargs):
        out = grids(*args, **kwargs)
        ok = out[-1].clone()
        ok[..., window:, :] = False
        return out[:-1] + (ok,)

    PBD.banded_pair_grids = cut_grids
    PBD.column_window_miss = lambda s_mn, s_mx, s_col, K, occ=None: cert(s_mn, s_mx, s_col,
                                                                         window, occ)
    try:
        yield
    finally:
        PBD.banded_pair_grids, PBD.column_window_miss = grids, cert


def window_narrowed(step):
    def run(state, dt):
        with narrowed(NARROW):
            return step(state, dt)
    return run


def test_a_sound_window_is_correct(landed):
    assert judged(*landed)[0]


@pytest.mark.parametrize("fault", [unchanged, moved, carry_zeroed, window_narrowed])
def test_a_planted_fault_is_not_correct(landed, fault):
    assert not judged(*landed, fault=fault)[0]


def test_the_narrowed_window_drops_contacts(landed):
    """The narrowed window's certificate counts the contacts it may drop."""
    _cell, step, _got, state = landed
    out = window_narrowed(step)(state, DT)
    assert int(out.modules["physics"].counters["sap_window_miss"].min()) > 0


def test_the_control_is_not_correct(landed):
    """The reference in bfloat16 in the program's place fails at least one
    number."""
    correct, numbers = judged(*landed, lower=True)
    limits = landed[0].config["limits"]
    assert not correct
    assert any(math.isnan(v) or v > limits[k] for k, v in numbers.items())


def test_the_reference_loads_nothing_of_the_port():
    """banded_boxes built and stepped in a fresh process: no module of the
    port or of the JAX side is loaded."""
    code = (
        f"import sys; sys.path.insert(0, {spec.ROOT!r})\n"
        "import torch\n"
        "from benchmark.reference import banded_boxes as bb\n"
        f"cfg = {{'args': {ARGS!r}}}\n"
        "m = bb.Model(bb.build(cfg, 3), 'cpu')\n"
        "m.frame(m.start(2, torch.Generator().manual_seed(3)), 1 / 60)\n"
        "print(sorted({n.split('.')[0] for n in sys.modules} & {'lumixengine_tpu_torch', "
        "'lumixengine_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_scene_is_the_same_on_both_sides():
    """The reference's lattice and camera equal the port's scene's."""
    prog = scenes.build({"builder": "models.demo_scenes.box_drop_world", "args": ARGS}, SEED,
                        "cpu")
    scene = bb.build({"args": ARGS}, scenes.seed_of(SEED))
    pm = prog.world.modules["physics"]
    st = pm.device_state("cpu")
    assert torch.equal(st.pos[:, :ARGS["num_bodies"]], torch.as_tensor(scene.boxes.T))
    cam = prog.world.device_state("cpu").local.pos[:, 0]
    assert torch.equal(cam, torch.tensor(scene.camera[0], dtype=torch.float32))
