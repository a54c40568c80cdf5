"""The frozen work counts equal the port's as of the benchmark's commit."""
import pytest

from lumixengine_tpu_torch.ops import culling, solver

from benchmark.harness import counts


@pytest.mark.parametrize("w,k", [(1, 1), (1024, 10240), (4096, 10240), (4096, 264), (7, 33)])
def test_k1_counts(w, k):
    assert counts.k1_bytes(w, k) == culling.k1_bytes(w, k)
    assert counts.k1_flops(w, k) == culling.k1_flops(w, k)


@pytest.mark.parametrize("w,nb,c,act,pair", [(1, 1, 4, 0, 0), (1024, 64, 1792, 179050, 90000),
                                             (4096, 64, 1792, 500000, 200000),
                                             (4096, 37, 2508, 1, 1)])
def test_k2_counts(w, nb, c, act, pair):
    assert counts.k2_bytes(w, nb, c, act) == solver.k2_bytes(w, nb, c, act)
    assert counts.k2_flops(w, nb, c, act, pair, 10, 3) == solver.k2_flops(w, nb, c, act, pair,
                                                                           10, 3)


def test_roofline_share():
    # 3.35e9 bytes at 3.35 TB/s take 1 ms: a 2 ms kernel is at half its roofline
    assert counts.roofline_share(3_350_000_000, 0, 2e-3) == pytest.approx(50.0)
    assert counts.roofline_share(0, 67_000_000_000, 1e-3) == pytest.approx(100.0)
