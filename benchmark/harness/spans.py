"""The program's own spans: the ``core/profiler`` blocks that the frame step
records (``engine.frame``, ``<module>.<phase>``, ``hierarchy.propagate``,
the extra pass's span and the layers' sub-spans), read once a run and kept
on the ``Run``.

Two passes, each from the window's last state, each leaving it as it was
(the step is functional):

* the host pass: the traffic's ``trace_frames`` frames with the recorder on
  and no profiler session, as in the window. The ring gives the host's
  milliseconds in each span, and in ``engine.frame`` the host's time in the
  step: dispatch, and any wait on a full launch queue or a synchronise;
* the op pass: one frame under a ``TorchDispatchMode`` that stamps each
  non-view torch operation on the host's clock (the rule of
  ``metrics/frame.torch_ops.py``), each put down to the spans holding it;
* the device pass: ``labelled_frames`` frames under ``torch.profiler``
  with the host's and the device's activity, where every block is also a
  ``record_function`` span. Each device operation is tied to the runtime
  call that launched it (the runtime event whose correlation id it shares,
  else the host event its ``linked_correlation_id`` names) and counted in
  the innermost span whose host interval holds that launch, and in every
  span that contains that one (inclusive). The blocking runtime calls
  inside ``engine.frame`` are counted; each idle gap of the device is put
  down to the innermost span running on the host at its middle.

Spans are keyed by their path, the names from ``engine.frame`` down (a
span such as ``animation.palette`` sits under two phases); a span's number
by name sums its paths. A per-span table goes to standard error. Off the card, or on a program
without the spans, ``of`` gives None and every reader of it gives None.
"""
from __future__ import annotations

import bisect
import statistics
import sys
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.harness import trace

FRAME = "engine.frame"
PHASES = ("end_frame", "update_parallel", "update", "late_update")
# the CUDA runtime calls that hold the host until the device has caught up
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy")
OUTSIDE = ("(outside engine.frame)",)
_MEMO = "_program_spans"

Path = Tuple[str, ...]


@dataclass
class Spans:
    """Each span's numbers a frame, by path. `device_ms` and `ops` are
    inclusive (a span's children count toward it); `own_ms` is what was
    launched in a span outside its children; `idle_ms` and `syncs` go by
    the innermost span (OUTSIDE where no engine.frame held the time)."""

    frames: int                       # frames of the device pass
    host_frames: int                  # frames of the host pass
    frame_host_ms: List[float]        # engine.frame's host ms, each frame of the host pass
    order: List[Path] = field(default_factory=list)
    host_ms: Dict[Path, float] = field(default_factory=dict)
    device_ms: Dict[Path, float] = field(default_factory=dict)
    own_ms: Dict[Path, float] = field(default_factory=dict)
    ops: Dict[Path, float] = field(default_factory=dict)
    idle_ms: Dict[Path, float] = field(default_factory=dict)
    syncs: Dict[Path, float] = field(default_factory=dict)
    host_syncs: float = 0.0           # blocking runtime calls inside engine.frame
    traced_device_ms: float = 0.0     # every device operation of the pass
    unlinked_ms: float = 0.0          # device operations whose launch was not found

    def by_name(self, numbers: Dict[Path, float], name: str) -> Optional[float]:
        """A span's number summed over its paths; None where it never ran."""
        found = [p for p in self.order if p[-1] == name]
        return sum(numbers.get(p, 0.0) for p in found) if found else None


# -- nesting and attribution (plain data; the tests feed synthetic spans) --------------------

def nest(spans: Sequence[Tuple[str, float, float]]):
    """Spans (name, start, end) of one thread, sorted by start with the
    outer first at equal starts, and each one's path: its name after the
    names of the spans that contain it."""
    ordered = sorted(spans, key=lambda s: (s[1], -s[2]))
    parents, paths, stack = [], [], []
    for i, (name, _a, b) in enumerate(ordered):
        while stack and ordered[stack[-1]][2] < b:
            stack.pop()
        parents.append(stack[-1] if stack else -1)
        paths.append((paths[stack[-1]] if stack else ()) + (name,))
        stack.append(i)
    return ordered, parents, paths


def innermost(ordered, parents, starts, t: float) -> int:
    """The index of the innermost span holding time t, or -1."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and ordered[i][2] < t:
        i = parents[i]
    return i


def attribute(spans, items):
    """Values at host times, put into spans: `items` are (t, value). Returns
    (inclusive sums by path, sums by innermost path with OUTSIDE for what
    no span holds)."""
    ordered, parents, paths = nest(spans)
    starts = [s[1] for s in ordered]
    total, own = defaultdict(float), defaultdict(float)
    for t, v in items:
        i = innermost(ordered, parents, starts, t)
        own[paths[i] if i >= 0 else OUTSIDE] += v
        while i >= 0:
            total[paths[i]] += v
            i = parents[i]
    return dict(total), dict(own)


def _cpu(e) -> bool:
    return e.device_type == DeviceType.CPU and not e.is_async


def launches(events):
    """(host time of the launch or None, device us) of every device
    operation: the runtime call sharing its correlation id, else the host
    event its ``linked_correlation_id`` names."""
    runtime, host = {}, {}
    for e in events:
        if _cpu(e):
            (runtime if e.name.startswith("cu") else host).setdefault(e.id, e.time_range.start)
    out = []
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        t = runtime.get(e.id)
        if t is None:
            t = host.get(getattr(e, "linked_correlation_id", 0))
        out.append((t, e.time_range.end - e.time_range.start))
    return out


# -- the passes ---------------------------------------------------------------------------------

def recorded(fn):
    """fn() with the program's recorder on (and no profiler session unless
    fn opens one), its state put back after: (fn's result, the ring's
    blocks of this thread that started during the call)."""
    from lumixengine_tpu_torch.core import profiler

    was_enabled, was_paused = profiler._enabled, profiler._paused
    profiler.enable(True)
    profiler.pause(False)
    t0 = time.perf_counter()
    try:
        out = fn()
    finally:
        profiler.enable(was_enabled)
        profiler.pause(was_paused)
    me = threading.get_ident()
    return out, [(n, a, b) for n, a, b, tid in profiler.blocks() if a >= t0 and tid == me]


def run_frames(step, state, dt, frames: int, sync):
    sync()
    for _ in range(frames):
        state = step(state, dt)
    sync()


class _StampOps(TorchDispatchMode):
    """The host time of every non-view torch operation dispatched."""

    def __init__(self):
        super().__init__()
        self.stamps = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not getattr(func, "is_view", False):
            self.stamps.append(time.perf_counter())
        return func(*args, **(kwargs or {}))


def host_pass(step, state, dt, frames: int, sync):
    """(engine.frame's host ms each frame, {path: host ms a frame})."""
    _, blocks = recorded(lambda: run_frames(step, state, dt, frames, sync))
    ordered, _parents, paths = nest(blocks)
    host = defaultdict(float)
    for (_n, a, b), path in zip(ordered, paths):
        host[path] += (b - a) * 1e3 / frames
    return [(b - a) * 1e3 for n, a, b in blocks if n == FRAME], dict(host)


def op_pass(step, state, dt, sync):
    """{path: non-view torch ops} of one frame, inclusive."""
    def stamped():
        with _StampOps() as mode:
            run_frames(step, state, dt, 1, sync)
        return mode.stamps

    stamps, blocks = recorded(stamped)
    return attribute(blocks, ((t, 1.0) for t in stamps))[0]


def device_pass(step, state, dt, frames: int, sync, cuda: bool):
    """The profiler over `frames` frames, with the program's spans in it."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def profiled():
        with profile(activities=acts) as prof:
            run_frames(step, state, dt, frames, sync)
        return prof

    prof, blocks = recorded(profiled)
    names = {n for n, _a, _b in blocks}
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if _cpu(e) and e.is_user_annotation and e.name in names]
    return prof, spans


def measure(step, state, dt, frames: int, labelled: int, sync, cuda: bool = True
            ) -> Optional[Spans]:
    """The three passes from `state`; None where the step records no
    engine.frame."""
    frame_ms, host = host_pass(step, state, dt, frames, sync)
    if not frame_ms:
        return None
    ops = op_pass(step, state, dt, sync)
    prof, spans = device_pass(step, state, dt, labelled, sync, cuda)
    events = prof.events()
    per = 1.0 / labelled
    paths = nest(spans)[2]
    out = Spans(labelled, frames, frame_ms, order=list(dict.fromkeys(paths)), host_ms=host,
                ops=ops)

    dev = launches(events)
    out.traced_device_ms = sum(us for _t, us in dev) / 1e3 * per
    out.unlinked_ms = sum(us for t, us in dev if t is None) / 1e3 * per
    out.device_ms, out.own_ms = attribute(
        spans, ((t, us / 1e3 * per) for t, us in dev if t is not None))

    syncs = [e.time_range.start for e in events if _cpu(e) and e.name in BLOCKING]
    total, out.syncs = attribute(spans, ((t, per) for t in syncs))
    out.host_syncs = total.get((FRAME,), 0.0)

    frames_only = [s for s in spans if s[0] == FRAME]
    intervals = trace.device_intervals(prof)
    if intervals and frames_only:
        lo = min(a for _n, a, _b in frames_only)
        hi = max([b for _n, _a, b in frames_only] + [b for _n, _a, b in intervals])
        held = trace.union(((a, b) for _n, a, b in intervals), lo, hi)
        out.idle_ms = attribute(spans, (((a + b) / 2, (b - a) / 1e3 * per)
                                        for a, b in trace.gaps(held, lo, hi)))[1]
    return out


def table(sp: Spans) -> List[str]:
    """The per-span table, nested by containment, as lines."""
    syncs = {"/".join(p): v for p, v in sp.syncs.items()}
    lines = [f"spans: {sp.frames} device-pass frames, {sp.host_frames} host-pass frames; "
             f"engine.frame host ms median {statistics.median(sp.frame_host_ms):.3f} "
             f"(each: {', '.join(f'{v:.3f}' for v in sp.frame_host_ms)}); "
             f"blocking calls a frame in engine.frame {sp.host_syncs:g}, by span {syncs}; "
             f"traced device ms a frame {sp.traced_device_ms:.4f}, unlinked {sp.unlinked_ms:.4f}",
             f"{'span (a frame)':<36} {'device ms':>10} {'own ms':>10} {'host ms':>10} "
             f"{'ops':>7} {'idle ms':>9}"]
    for p in sp.order + ([OUTSIDE] if OUTSIDE in sp.idle_ms else []):
        lines.append(f"{'  ' * (len(p) - 1) + p[-1]:<36} {sp.device_ms.get(p, 0.0):>10.4f} "
                     f"{sp.own_ms.get(p, 0.0):>10.4f} {sp.host_ms.get(p, 0.0):>10.4f} "
                     f"{sp.ops.get(p, 0.0):>7.0f} {sp.idle_ms.get(p, 0.0):>9.4f}")
    return lines


def of(run) -> Optional[Spans]:
    """The run's spans, measured at the first call and kept on the run;
    None off the card or where the program records no engine.frame."""
    if hasattr(run, _MEMO):
        return getattr(run, _MEMO)
    sp = None
    if run.on_card:
        traffic = run.cell.traffic
        sp = measure(run.step, run.state, run.dt, int(traffic["trace_frames"]),
                     int(traffic["labelled_frames"]), run.clock.sync)
        for line in table(sp) if sp is not None else ["spans: the step records no engine.frame"]:
            print(line, file=sys.stderr, flush=True)
    setattr(run, _MEMO, sp)
    return sp


def device_ms(run, *names: str) -> Optional[float]:
    """The device ms a frame of the named spans together; None where none
    of them ran."""
    sp = of(run)
    if sp is None:
        return None
    found = [v for v in (sp.by_name(sp.device_ms, n) for n in names) if v is not None]
    return sum(found) if found else None


def phase_spans(module: str) -> Tuple[str, ...]:
    """The names of a module's phase spans."""
    return tuple(f"{module}.{p}" for p in PHASES)
