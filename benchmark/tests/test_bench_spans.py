"""The program's spans as the harness reads them (harness/spans.py): the
attribution on synthetic spans and events, the passes on the CPU at a small
size, every reader of them None off the card, and on the card the spans
accounting for the frame's device time."""
import time
import types

import pytest
import torch
from torch.autograd import DeviceType

from benchmark.harness import cell as cells
from benchmark.harness import spans, spec, window
from benchmark.tests.small import SEED, small_cell

FRAME = ("engine.frame",)
READERS = ["animation.in_frame_ms", "physics.in_frame_ms", "particles.in_frame_ms",
           "hierarchy.in_frame_ms", "cull.in_frame_ms", "particles.random_ms",
           "physics.contacts_ms", "animation.palette_ms", "frame.host_ms", "frame.host_syncs"]
# a frame [0, 100]: a phase [10, 50] holding a sub-span [20, 30], a second phase [60, 90]
SYNTHETIC = [("engine.frame", 0, 100), ("a.update", 10, 50), ("a.palette", 20, 30),
             ("b.update", 60, 90)]


def test_the_innermost_span_wins_and_children_count_to_their_parents():
    total, own = spans.attribute(SYNTHETIC, [(25, 1.0), (40, 2.0), (70, 4.0), (95, 8.0)])
    assert own == {FRAME + ("a.update", "a.palette"): 1.0, FRAME + ("a.update",): 2.0,
                   FRAME + ("b.update",): 4.0, FRAME: 8.0}
    assert total == {FRAME: 15.0, FRAME + ("a.update",): 3.0,
                     FRAME + ("a.update", "a.palette"): 1.0, FRAME + ("b.update",): 4.0}


def test_a_launch_outside_every_span_counts_to_no_layer():
    total, own = spans.attribute(SYNTHETIC, [(-5, 1.0), (150, 2.0), (55, 4.0)])
    assert own == {spans.OUTSIDE: 3.0, FRAME: 4.0}
    assert total == {FRAME: 4.0}


def test_a_name_sums_its_paths_and_is_none_where_it_never_ran():
    sp = spans.Spans(1, 1, [1.0], order=[FRAME, FRAME + ("a.update", "a.palette"),
                                         FRAME + ("b.update", "a.palette")],
                     device_ms={FRAME + ("a.update", "a.palette"): 1.5,
                                FRAME + ("b.update", "a.palette"): 2.0})
    assert sp.by_name(sp.device_ms, "a.palette") == 3.5
    assert sp.by_name(sp.device_ms, "engine.frame") == 0.0
    assert sp.by_name(sp.device_ms, "c.update") is None


def event(name, eid, start, end, device=DeviceType.CPU, linked=0):
    return types.SimpleNamespace(name=name, id=eid, linked_correlation_id=linked,
                                 device_type=device, is_async=False, is_user_annotation=False,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_a_device_operation_is_tied_to_the_call_that_launched_it():
    events = [event("aten::mul", 7, 10, 20), event("cudaLaunchKernel", 501, 12, 13, linked=7),
              event("kernel_a", 501, 30, 34, DeviceType.CUDA, linked=7),
              event("kernel_b", 502, 40, 41, DeviceType.CUDA, linked=7),   # no runtime call
              event("kernel_c", 503, 50, 52, DeviceType.CUDA, linked=99)]  # nothing to tie to
    assert spans.launches(events) == [(12, 4), (10, 1), (None, 2)]


def test_the_passes_on_the_cpu_find_every_span_and_count_every_op():
    """Three passes of a small flagship on the CPU: every span the step
    records, engine.frame's op count equal to frame.torch_ops's, no device
    operation, and the recorder put back as it was."""
    from lumixengine_tpu_torch.core import profiler

    cell = small_cell("full_frame.w4096", worlds=2)
    _scene, step, state, _r = cells.set_up(cell, SEED, "cpu")
    profiler.enable(False)
    try:
        sp = spans.measure(step, state, 1 / 60, 2, 1, lambda: None, cuda=False)
        assert not profiler._enabled
    finally:
        profiler.enable(True)
    names = {p[-1] for p in sp.order}
    assert {"engine.frame", "animation.update_parallel", "animation.palette",
            "physics.update_parallel", "physics.contacts", "physics.solve", "renderer.update",
            "particles.random", "hierarchy.propagate", "renderer.cull_pass"} <= names
    assert sp.order[0] == FRAME and all(p[0] == "engine.frame" for p in sp.order)
    assert len(sp.frame_host_ms) == 2 and all(ms > 0 for ms in sp.frame_host_ms)
    ops = spec.reader("frame.torch_ops").count_ops(lambda: step(state, 1 / 60))[1]
    assert sp.ops[FRAME] == ops
    assert sp.ops[FRAME] >= sum(v for p, v in sp.ops.items() if len(p) == 2)
    assert sp.traced_device_ms == 0 and sp.host_syncs == 0


@pytest.fixture(scope="module")
def cpu_run():
    cell = small_cell("full_frame.w4096", worlds=2)
    scene, step, state, _r = cells.set_up(cell, SEED, "cpu")
    clock = window.Clock("cpu")
    win = window.run(step, state, 1 / 60, 0.0, clock)
    return cells.Run(cell, scene, step, clock, 1 / 60, 0.0, win, win.state, None, None)


@pytest.mark.parametrize("name", READERS)
def test_every_reader_of_the_spans_is_none_off_the_card(name, cpu_run):
    assert spec.reader(name).read(cpu_run) is None


@pytest.mark.gpu
def test_the_spans_account_for_the_frame_on_the_card():
    """The top-level spans' device ms, and what engine.frame launched
    outside them, sum to every device operation traced, within 0.5%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device pass traces the card")
    cell = small_cell("full_frame.w4096", worlds=8)
    _scene, step, state, _r = cells.set_up(cell, SEED, "cuda:0")
    t = time.perf_counter()
    sp = spans.measure(step, state, 1 / 60, 3, 2, torch.cuda.synchronize)
    print("\n".join(spans.table(sp)), f"\nmeasured in {time.perf_counter() - t:.3f} s")
    top = sum(v for p, v in sp.device_ms.items() if len(p) == 2)
    assert sp.traced_device_ms > 0
    assert abs(top + sp.own_ms.get(FRAME, 0.0) - sp.traced_device_ms) <= 0.005 * sp.traced_device_ms
    assert sp.by_name(sp.device_ms, "particles.random") > 0
