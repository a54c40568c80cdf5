"""A small cell run on the card: the kernels K1 and K2 in the program's
place, held to the plain reference. Needs a CUDA device; run on the card
with ``python -m pytest -m gpu benchmark/tests``."""
import time

import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.tests.small import SEED, small_cell


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["full_frame.w4096", "crowd.w4096"])
def test_a_small_cell_on_the_card_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 run only on the card")
    r = cells.run_cell(small_cell(name, worlds=8), SEED, 1.0, True, "cuda:0", time.perf_counter())
    assert r["correct"], r["compared"]
    assert r["device"]["busy_s"] > 0 and r["metrics"]["k1_roofline"]["value"] <= 105
