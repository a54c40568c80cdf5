"""The measured window: the program's step called frame after frame for a
fixed number of seconds, with a CUDA event at every frame boundary and no
synchronise inside. The rate is taken over all frames and all the time
between the first frame's start event and the last frame's end event; the
tail over every frame's time."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import torch


class Clock:
    """Marks on the device's timeline: CUDA events on the card. On the CPU,
    where the harness's tests run, the host's clock stands in."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


@dataclass
class Window:
    frames: int = 0
    frame_ms: List[float] = field(default_factory=list)
    seconds: float = 0.0          # first frame's start to last frame's end, device timeline
    host_seconds: float = 0.0     # the host's loop, to the synchronise after it
    prev: object = None           # the state the last frame started from
    state: object = None          # the state the last frame produced


def run(step, state, dt: float, seconds: float, clock: Clock, min_frames: int = 2) -> Window:
    """Frames of `step` until `seconds` of the host's clock have passed
    (and at least `min_frames`). The states before and after the last frame
    are kept: the step is functional, so keeping them costs nothing."""
    clock.sync()
    t0 = time.perf_counter()
    marks = [clock.mark()]
    prev = state
    while True:
        prev = state
        state = step(state, dt)
        marks.append(clock.mark())
        if len(marks) > min_frames and time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    host = time.perf_counter() - t0
    frame_ms = [clock.ms(a, b) for a, b in zip(marks, marks[1:])]
    return Window(len(frame_ms), frame_ms, clock.ms(marks[0], marks[-1]) / 1e3, host, prev,
                  state)
