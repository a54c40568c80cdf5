"""Readings from ``torch.profiler``: the device time of a call, and the
trace of the program's step over frames of the window (busy time, the
traced window's length, the device operations that took most time, and
the idle gaps by what the host was doing during each)."""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

FRAME_SPAN = "benchmark.frame"
PROFILER_OWN = "Activity Buffer Request"   # the profiler's own work on the host
TOP = 10
NAME_CHARS = 160


def device_intervals(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every operation that ran on the device:
    kernels, copies and sets, not the spans the profiler mirrors onto the
    device's timeline."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.name != FRAME_SPAN]


def device_ms(fn, reps: int, sync) -> Optional[float]:
    """Device time of one call of fn(), in ms, summed over the operations
    the profiler saw run on the device, over `reps` calls; None where it saw
    none (a CPU run, or a profiler that does not trace the card)."""
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    total = sum(b - a for _n, a, b in device_intervals(prof))
    return total / 1e3 / reps if total > 0 else None


def union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals clipped to [lo, hi], merged."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no busy interval covers."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def host_op_at(ops, starts, t: float, reach: int = 256) -> str:
    """The innermost host operation running at time t: of those started by
    t and not yet ended, the one started last."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - reach, -1), -1):
        name, a, b = ops[j]
        if b >= t:
            return name
    return "python (no torch op)"


def top(pairs, n: int = TOP):
    """[[name, seconds], ...]: the n largest sums of seconds by name."""
    sums = defaultdict(float)
    for name, s in pairs:
        sums[name[:NAME_CHARS]] += s
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


@dataclass
class StepTrace:
    frames: int
    busy_s: float
    window_s: float
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def busy(prof, frames: int) -> StepTrace:
    """Busy time over the traced window, from the device's operations alone:
    the window runs from the first operation's start to the last one's end."""
    dev = device_intervals(prof)
    if not dev:
        return StepTrace(frames, 0.0, 0.0)
    lo, hi = min(a for _n, a, _b in dev), max(b for _n, _a, b in dev)
    busy_us = sum(b - a for a, b in union(((a, b) for _n, a, b in dev), lo, hi))
    return StepTrace(frames, busy_us / 1e6, (hi - lo) / 1e6,
                     top((n, (b - a) / 1e6) for n, a, b in dev))


def idle_gaps(prof):
    """The idle gaps between the first frame span's start and the last
    device operation's end, summed by the innermost host operation running
    at each gap's middle."""
    events = prof.events()
    spans = [e.time_range for e in events if e.name == FRAME_SPAN]
    dev = device_intervals(prof)
    if not spans:
        return []
    lo = min(r.start for r in spans)
    hi = max([r.end for r in spans] + [b for _n, _a, b in dev])
    ops = sorted(((e.name, e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CPU and not e.is_async
                  and e.name not in (FRAME_SPAN, PROFILER_OWN)), key=lambda o: o[1])
    starts = [o[1] for o in ops]
    held = union(((a, b) for _n, a, b in dev), lo, hi)
    return top((host_op_at(ops, starts, (a + b) / 2), (b - a) / 1e6) for a, b in gaps(held, lo, hi))


def trace_step(step, state, dt, frames: int, labelled: int, sync, cuda: bool = True):
    """The program's step under the profiler: `frames` frames with the
    device's activity alone, for the busy time and the device operations
    (recording the host's operations as well adds to the host's cost of
    every operation, which would read as idle time), then `labelled`
    frames with the host's operations too, each in a span of the
    benchmark's own, for what the host was doing in each idle gap. Returns (state before the last
    frame, last state, StepTrace). Without `cuda` (the harness's tests on
    the CPU) there is no device to trace: the frames run and read nothing."""
    prev = state
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) if cuda else contextlib.nullcontext() as prof:
        for _ in range(frames):
            prev, state = state, step(state, dt)
        sync()
    out = busy(prof, frames) if cuda else StepTrace(frames, 0.0, 0.0)
    host = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=host) as prof:
        for _ in range(labelled):
            prev = state
            with record_function(FRAME_SPAN):
                state = step(state, dt)
        sync()
    out.idle_gaps = idle_gaps(prof)
    return prev, state, out
