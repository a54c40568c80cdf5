"""The readings that a cell's limits are set from (not run by the benchmark's
own runs).

    python3 benchmark/tools/readings.py --workload <cell> --frames <n> --seeds <s> [<s> ...]

For each seed, in one process: the program's set-up at the cell's own size,
`--frames` frames after the warm frames (about as many as a run's window
completes), then the numbers the check compares, first of the program and
then of the control: the reference put in the program's place with its
state held in bfloat16, the precision below the configuration's float32.
One JSON line a seed on standard output. On a machine without a CUDA
device it runs on the CPU (at the cell's size: use it there only through
the tests, which shrink the cell).
"""
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402

import torch  # noqa: E402

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import spec, tree  # noqa: E402


def readings(cell: spec.Cell, seed: int, frames: int, device) -> dict:
    t = time.perf_counter()
    _scene, step, state, got = cells.set_up(cell, seed, device)
    dt = float(cell.traffic["dt"])
    prev = state
    for _ in range(frames):
        prev, state = state, step(state, dt)
    got.prev, got.last = tree.flatten(prev), tree.flatten(state)
    del _scene, step, prev, state
    program = cells.judge(cell, got, seed, device)
    control = cells.judge(cell, got, seed, device, lower=True)
    return {"workload": cell.name, "seed": seed, "frames": frames,
            "program": program[0], "program_failed": program[2],
            "control": control[0], "control_failed": control[2], "attempted": program[1],
            "limits": cell.config["limits"], "seconds": time.perf_counter() - t}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--frames", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.frames, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
