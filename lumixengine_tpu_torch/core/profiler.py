"""Profiler (≙ reference core/profiler.{h,cpp} + docs/profiler.md).

Reference: two-part tracing profiler — per-thread fixed ring buffers recording
explicit blocks (PROFILE_FUNCTION/PROFILE_BLOCK), named counters, string/int
properties, fiber-wait events and GPU scopes; viewed in the editor flamegraph.

The port's copy of ``lumixengine_tpu/core/profiler.py``: the same two
notions, host-side:
  * blocks  — context managers recording (name, t0, t1, thread) into a ring.
    A block costs one flag test when the recorder is off (``enable(False)``
    or ``pause(True)``), and two clock reads and a ring append when it is
    on. Under a ``torch.profiler`` session it also opens a
    ``record_function`` span of the same name, so the block stands in the
    session's trace beside the device's kernels (≙ GPU scopes calibrated to
    CPU clock); outside one it dispatches no op, so a ``TorchDispatchMode``
    counting a step's ops sees none of the step's blocks.
  * counters — named time series (frame dt, allocator MB analogs, particle /
    culling counts come from module counters each frame).
Export: chrome://tracing JSON (the flamegraph viewer stand-in), stamped in
wall-clock µs as a ``torch.profiler`` export is once its
``baseTimeNanoseconds`` is added, so the two files of the same frames line
up in one viewer.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Deque, Dict, List, Tuple

import torch
from torch.autograd import profiler as _torch_profiler

_RING = 65536

_blocks: Deque[Tuple[str, float, float, int]] = deque(maxlen=_RING)
_counters: Dict[str, Deque[Tuple[float, float]]] = {}
_frames: Deque[float] = deque(maxlen=_RING)
_lock = threading.Lock()
_enabled = True
_paused = False
_recording = True          # _enabled and not _paused: the one flag a block tests
# wall-clock seconds less the ring's perf_counter seconds, read once
_WALL_OFFSET = time.time() - time.perf_counter()


def enable(on: bool = True) -> None:
    global _enabled, _recording
    _enabled = on
    _recording = _enabled and not _paused


def pause(on: bool = True) -> None:
    """≙ profiler::pause — keep ring contents, stop recording."""
    global _paused, _recording
    _paused = on
    _recording = _enabled and not _paused


_OFF = nullcontext()       # the block of a recorder that is off: no clock read, no torch call


class _Block:
    __slots__ = ("name", "t0", "span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.span = None
        if _torch_profiler._is_profiler_enabled:
            self.span = torch.profiler.record_function(self.name)
            self.span.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.span is not None:
            self.span.__exit__(None, None, None)
        with _lock:
            _blocks.append((self.name, self.t0, t1, threading.get_ident()))


def block(name: str):
    """≙ PROFILE_BLOCK / PROFILE_FUNCTION: a context manager recording
    (name, t0, t1, thread) into the ring when it exits."""
    return _Block(name) if _recording else _OFF


def create_counter(name: str) -> None:
    """≙ profiler::createCounter."""
    _counters.setdefault(name, deque(maxlen=_RING))


def push_counter(name: str, value: float) -> None:
    """≙ profiler::pushCounter."""
    _counters.setdefault(name, deque(maxlen=_RING)).append((time.perf_counter(), float(value)))


def frame() -> None:
    """Frame marker (≙ profiler frame events)."""
    if _recording:
        _frames.append(time.perf_counter())


def counters(name: str) -> List[Tuple[float, float]]:
    return list(_counters.get(name, ()))


def blocks() -> List[Tuple[str, float, float, int]]:
    with _lock:
        return list(_blocks)


def clear() -> None:
    with _lock:
        _blocks.clear()
        _frames.clear()
        for c in _counters.values():
            c.clear()


def _wall_us(t: float) -> float:
    """A ring time (``time.perf_counter`` seconds) in wall-clock µs, the
    clock of a ``torch.profiler`` export's times plus its
    ``baseTimeNanoseconds``."""
    return (t + _WALL_OFFSET) * 1e6


def export_chrome_trace(path: str) -> None:
    """chrome://tracing JSON — the editor flamegraph viewer stand-in. Times
    are wall-clock µs (``baseTimeNanoseconds`` 0), so a ``torch.profiler``
    export of the same frames, its times moved by its own base, merges with
    this one."""
    events = []
    for name, t0, t1, tid in blocks():
        events.append({
            "name": name, "ph": "X", "ts": _wall_us(t0), "dur": (t1 - t0) * 1e6,
            "pid": 0, "tid": tid,
        })
    for t in list(_frames):
        events.append({"name": "frame", "ph": "i", "ts": _wall_us(t), "pid": 0, "tid": 0,
                       "s": "g"})
    for cname, series in _counters.items():
        for t, v in series:
            events.append({"name": cname, "ph": "C", "ts": _wall_us(t), "pid": 0,
                           "args": {cname: v}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": 0}, f)
