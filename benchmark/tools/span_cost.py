"""What the program's spans cost: a cell's frame time with the recorder off
(``core/profiler.enable(False)``), on without a profiler session (the
default, as in the benchmark's window), and under ``torch.profiler`` with
the host's and the device's activity (as the device pass of
``harness/spans.py``), in turns, on the card.

    python3 benchmark/tools/span_cost.py --workload full_frame.w4096 --seed 7 --frames 12 --rounds 2

Each state runs `--frames` frames after one warm frame, with a CUDA event
at every frame boundary; one JSON line gives each state's median frame ms
per round and overall, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def frames_ms(step, state, dt, frames: int, clock, state_name: str):
    """Per-frame ms of `frames` frames in one recorder state; the state after."""
    from torch.profiler import ProfilerActivity, profile

    from lumixengine_tpu_torch.core import profiler

    profiler.enable(state_name != "off")
    try:
        state = step(state, dt)
        clock.sync()
        marks = []

        def run():
            nonlocal state
            marks.append(clock.mark())
            for _ in range(frames):
                state = step(state, dt)
                marks.append(clock.mark())
            clock.sync()

        if state_name == "profiler":
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                run()
        else:
            run()
    finally:
        profiler.enable(True)
    return [clock.ms(a, b) for a, b in zip(marks, marks[1:])], state


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="full_frame.w4096")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import spec, window

    if not torch.cuda.is_available():
        print("span_cost needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    dt = float(cell.traffic["dt"])
    clock = window.Clock("cuda:0")
    _scene, step, state, _r = cells.set_up(cell, args.seed, "cuda:0")
    order = ("off", "ring", "profiler")
    rounds = {name: [] for name in order}
    every = {name: [] for name in order}
    for r in range(args.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            ms, state = frames_ms(step, state, dt, args.frames, clock, name)
            rounds[name].append(statistics.median(ms))
            every[name] += ms
    print(json.dumps({"workload": args.workload, "seed": args.seed, "frames": args.frames,
                      "card": cells.card_line(),
                      "median_ms": {k: statistics.median(v) for k, v in every.items()},
                      "round_medians_ms": rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
