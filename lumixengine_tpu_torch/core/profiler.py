"""Profiler (≙ reference core/profiler.{h,cpp} + docs/profiler.md).

Reference: two-part tracing profiler — per-thread fixed ring buffers recording
explicit blocks (PROFILE_FUNCTION/PROFILE_BLOCK), named counters, string/int
properties, fiber-wait events and GPU scopes; viewed in the editor flamegraph.

The port's copy of ``lumixengine_tpu/core/profiler.py``: the same two
notions, host-side:
  * blocks  — context managers recording (name, t0, t1, thread) into a ring;
    device work inside a block is additionally wrapped in
    torch.profiler.record_function so device traces line up when the user
    runs torch.profiler alongside (≙ GPU scopes calibrated to CPU clock).
  * counters — named time series (frame dt, allocator MB analogs, particle /
    culling counts come from module counters each frame).
Export: chrome://tracing JSON (the flamegraph viewer stand-in).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, List, Tuple

_RING = 65536

_blocks: Deque[Tuple[str, float, float, int]] = deque(maxlen=_RING)
_counters: Dict[str, Deque[Tuple[float, float]]] = {}
_frames: Deque[float] = deque(maxlen=_RING)
_lock = threading.Lock()
_enabled = True
_paused = False


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def pause(on: bool = True) -> None:
    """≙ profiler::pause — keep ring contents, stop recording."""
    global _paused
    _paused = on


@contextmanager
def block(name: str):
    """≙ PROFILE_BLOCK / PROFILE_FUNCTION."""
    if not _enabled or _paused:
        yield
        return
    try:
        import torch

        ann = torch.profiler.record_function(name)
        ann.__enter__()
    except Exception:
        ann = None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        if ann is not None:
            ann.__exit__(None, None, None)
        with _lock:
            _blocks.append((name, t0, t1, threading.get_ident()))


def create_counter(name: str) -> None:
    """≙ profiler::createCounter."""
    _counters.setdefault(name, deque(maxlen=_RING))


def push_counter(name: str, value: float) -> None:
    """≙ profiler::pushCounter."""
    _counters.setdefault(name, deque(maxlen=_RING)).append((time.perf_counter(), float(value)))


def frame() -> None:
    """Frame marker (≙ profiler frame events)."""
    if _enabled and not _paused:
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


def export_chrome_trace(path: str) -> None:
    """chrome://tracing JSON — the editor flamegraph viewer stand-in."""
    events = []
    for name, t0, t1, tid in blocks():
        events.append({
            "name": name, "ph": "X", "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
            "pid": 0, "tid": tid,
        })
    for t in list(_frames):
        events.append({"name": "frame", "ph": "i", "ts": t * 1e6, "pid": 0, "tid": 0, "s": "g"})
    for cname, series in _counters.items():
        for t, v in series:
            events.append({"name": cname, "ph": "C", "ts": t * 1e6, "pid": 0,
                           "args": {cname: v}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
