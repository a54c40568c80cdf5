"""The frame step's spans (``core/profiler`` blocks in ``Engine.build_step``
and the layers' sub-spans) and the recorder's three states: off (a flag
test, no clock read), on without a profiler session (the ring alone, no op
dispatched) and under ``torch.profiler`` (a ``record_function`` span of the
same name, on the export's clock)."""
import json
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from lumixengine_tpu_torch.core import profiler
from lumixengine_tpu_torch.engine.phase_profile import PHASES, _phase_overridden
from lumixengine_tpu_torch.models import demo_scenes as pds

torch.set_num_threads(1)
DT = 1.0 / 60.0
FRAMES = 2


@pytest.fixture(autouse=True)
def recorder():
    """The recorder as the module starts (on, not paused, the ring empty),
    and as it was after the test."""
    was = profiler._enabled, profiler._paused
    profiler.clear()
    profiler.enable(True)
    profiler.pause(False)
    yield
    profiler.clear()
    profiler.enable(was[0])
    profiler.pause(was[1])


def scene(kind):
    if kind == "demo":
        engine, world, _r = pds.headless_demo_world(64)
    else:
        engine, world, _r = pds.particle_stress_world(256)
    step = engine.build_step(world, "cpu", extra=world.modules["renderer"].cull_pass)
    return world, step, world.device_state("cpu")


def expected_spans(world):
    names = {f"{m.name}.{p}" for m in world.modules.values() for p in PHASES
             if _phase_overridden(m, p)}
    return names | {"hierarchy.propagate", "renderer.cull_pass"}


def profiled(step, state, frames=FRAMES):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(frames):
            state = step(state, DT)
    return prof.events()


def inside(span, e):
    return span.time_range.start <= e.time_range.start and e.time_range.end <= span.time_range.end


@pytest.mark.parametrize("kind", ["demo", "particles"])
def test_a_profiled_step_carries_each_span_inside_one_frame_span_a_frame(kind):
    world, step, state = scene(kind)
    events = [e for e in profiled(step, step(state, DT))
              if e.device_type == DeviceType.CPU and not e.is_async]
    frames = [e for e in events if e.name == "engine.frame"]
    assert len(frames) == FRAMES
    want = expected_spans(world) | ({"particles.random"} if kind == "particles" else set())
    assert "renderer.update" in want and "renderer.end_frame" in want
    for frame in frames:
        spans = {e.name for e in events if e.is_user_annotation and e is not frame
                 and inside(frame, e)}
        assert want <= spans, want - spans
    # the phases a module leaves to IModule get no span
    every_phase = {f"{m.name}.{p}" for m in world.modules.values() for p in PHASES}
    assert {e.name for e in events} & every_phase == expected_spans(world) & every_phase
    # every aten op of the step lies inside a frame span
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops and all(any(inside(f, e) for f in frames) for e in ops)


@pytest.mark.parametrize("on", [True, False])
def test_an_unprofiled_step_dispatches_no_profiler_op(on):
    """Whether the ring records or not, a step outside a profiler session
    dispatches no ``profiler.*`` op, so the benchmark's op count is the
    step's own."""
    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    _world, step, state = scene("particles")
    profiler.enable(on)
    with Seen() as seen:
        step(state, DT)
    assert seen.names and not [n for n in seen.names if n.startswith("profiler")]
    assert bool(profiler.blocks()) == on
    if on:
        assert [b[0] for b in profiler.blocks()].count("engine.frame") == 1


@pytest.mark.parametrize("off", ["enable", "pause"])
def test_an_off_block_reads_no_clock(off, monkeypatch):
    def no_clock():
        raise AssertionError("an off block read the clock")

    (profiler.enable(False) if off == "enable" else profiler.pause(True))
    monkeypatch.setattr(profiler, "time", types.SimpleNamespace(perf_counter=no_clock))
    with profiler.block("off"):
        pass
    profiler.frame()
    assert profiler.blocks() == []


def test_the_ring_and_a_profiler_export_share_one_clock(tmp_path):
    """A ring block and its record_function event agree within 1 ms once
    the profiler's times are moved by its baseTimeNanoseconds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with profiler.block(f"span{i}"):
                torch.ones(8).sum()
    prof.export_chrome_trace(str(tmp_path / "torch.json"))
    profiler.export_chrome_trace(str(tmp_path / "ring.json"))
    theirs = json.load(open(tmp_path / "torch.json"))
    ours = json.load(open(tmp_path / "ring.json"))
    base_us = theirs["baseTimeNanoseconds"] / 1e3
    torch_ts = {e["name"]: e["ts"] + base_us for e in theirs["traceEvents"]
                if e.get("cat") == "user_annotation"}
    ring_ts = {e["name"]: e["ts"] for e in ours["traceEvents"] if e["ph"] == "X"}
    assert ours["baseTimeNanoseconds"] == 0
    assert set(ring_ts) == {"span0", "span1", "span2"} <= set(torch_ts)
    for name, ts in ring_ts.items():
        assert abs(ts - torch_ts[name]) < 1e3, (name, ts, torch_ts[name])
