"""The trace's arithmetic: busy time as a union, idle gaps labelled by the
host operation running during each, and a window on the CPU reads no
device metric."""
import time

from benchmark.harness import cell as cells
from benchmark.harness import trace
from benchmark.tests.small import SEED, small_cell


def test_union_merges_and_clips():
    assert trace.union([(5, 7), (0, 2), (1, 3), (6, 9)], 1, 8) == [(1, 3), (5, 8)]
    assert trace.union([(0, 1)], 2, 3) == []


def test_gaps_are_the_complement():
    busy = trace.union([(1, 3), (5, 8)], 0, 10)
    assert trace.gaps(busy, 0, 10) == [(0, 1), (3, 5), (8, 10)]
    assert trace.gaps([], 2, 4) == [(2, 4)]


def test_host_op_at_takes_the_innermost():
    ops = sorted([("outer", 0, 100), ("inner", 10, 20), ("sibling", 30, 40)], key=lambda o: o[1])
    starts = [o[1] for o in ops]
    assert trace.host_op_at(ops, starts, 15) == "inner"
    assert trace.host_op_at(ops, starts, 25) == "outer"
    assert trace.host_op_at(ops, starts, 200) == "python (no torch op)"


def test_top_sums_by_name():
    assert trace.top([("a", 1.0), ("b", 0.5), ("a", 1.0)], 1) == [["a", 2.0]]


def test_a_traced_run_on_the_cpu_reads_no_device_metric():
    cell = small_cell("full_frame.w4096", worlds=2)
    r = cells.run_cell(cell, SEED, 0.3, True, "cpu", time.perf_counter())
    assert set(r["metrics"]) == {"frame.torch_ops"}
    assert r["device"]["busy_s"] == 0 and r["correct"]
    assert {m["name"] for m in cell.per_layer} >= {"k1_roofline", "device.idle_share"}
