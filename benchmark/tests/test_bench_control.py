"""The check separates: the bfloat16 control fails it, and so does each
fault a cell can have, planted under the timed path of a whole run (the
look for a card skipped); a sound run passes."""
import math
import time

import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import tree
from benchmark.tests.small import SEED, small_cell

CELLS = ["full_frame.w4096", "crowd.w4096"]


def unchanged(step):
    """A step that returns its state as it came."""
    return lambda state, dt: state


def half_batch(step):
    """Half of the worlds stepped; the rest left as they came."""
    def run(state, dt):
        out = tree.flatten(step(state, dt))
        ins = tree.flatten(state)
        w = next(iter(ins.values())).shape[0] // 2
        return tree.fill(state, {k: torch.cat([v[:w], ins[k][w:]]) for k, v in out.items()})
    return run


def altered(step):
    """One body or character moved by a centimetre in every world, where the
    step produces it."""
    def run(state, dt):
        out = step(state, dt)
        pos = out.local.pos.clone()
        pos[:, 1, -1] += 0.01
        return out.replace(local=out.local.replace(pos=pos))
    return run


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = cells.run_cell(small_cell(name), SEED, 0.5, False, "cpu", time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 9
    assert list(r)[-1] == "compared" and all(v["value"] == 0 for v in r["compared"].values())


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    r = cells.run_cell(small_cell(name, worlds=4), SEED, 0.3, False, "cpu", time.perf_counter(),
                       fault=fault)
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference in bfloat16 in the program's place fails at least one
    number on every seed tried."""
    cell = small_cell(name)
    for seed in (SEED, 7, 2 ** 31 + 99):
        _scene, step, state, got = cells.set_up(cell, seed, "cpu")
        prev = state
        for _ in range(20):
            prev, state = state, step(state, 1 / 60)
        got.prev, got.last = tree.flatten(prev), tree.flatten(state)
        numbers, _n, failed = cells.judge(cell, got, seed, "cpu", lower=True)
        limits = cell.config["limits"]
        assert failed > 0
        assert any(math.isnan(v) or v > limits[k] for k, v in numbers.items())
