"""One run of one cell: set-up, the measured window, the metrics, and the
check against the plain reference. ``main`` is ``benchmark/run.py``'s."""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Optional

import torch

from benchmark.harness import check, spec, trace, tree, window
from benchmark.harness import scene as scenes

FORBIDDEN = ("jax", "jaxlib", "flax", "lumixengine_tpu")
REPS = 3           # calls a phase's device time is averaged over
TIME_REPS = 20     # calls a kernel's time on CUDA events is averaged over


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi gave nothing"


@dataclass
class ProgramReadings:
    """What the check reads of the program's run (flat states)."""

    worlds: int
    seed: int
    rows: torch.Tensor
    start: dict
    first: Optional[dict]
    prev: Optional[dict]
    last: Optional[dict]


class Run:
    """What a metric's reader sees: the cell, the program's scene and step,
    the window, the trace, and the window's last state."""

    def __init__(self, cell, scene, step, clock, dt, setup_s, win, state, step_trace,
                 window_peak_bytes):
        self.cell, self.scene, self.step, self.clock = cell, scene, step, clock
        self.dt, self.setup_s, self.window, self.state = dt, setup_s, win, state
        self.trace, self.window_peak_bytes = step_trace, window_peak_bytes
        self.device = scene.device
        self.dt_tensor = torch.tensor(dt, dtype=torch.float32, device=self.device)
        self.worlds = int(cell.traffic["worlds"])

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def device_ms(self, fn, reps: int = REPS) -> Optional[float]:
        """Device time of one call of fn() by torch.profiler; None off the card."""
        return trace.device_ms(fn, reps, self.clock.sync) if self.on_card else None

    def phase_ms(self, module: str, phases) -> Optional[float]:
        """Device time of the module's phases, called through their public
        methods on the window's last state; None where the world lacks it."""
        m = self.scene.world.modules.get(module)
        if m is None:
            return None
        return self.device_ms(lambda: [getattr(m, p)(self.state, self.dt_tensor) for p in phases])

    def time_ms(self, fn, reps: int = TIME_REPS) -> Optional[float]:
        """Mean ms a call of fn() on CUDA events after a warm call; None off the card."""
        if not self.on_card:
            return None
        fn()
        a = self.clock.mark()
        for _ in range(reps):
            fn()
        b = self.clock.mark()
        self.clock.sync()
        return self.clock.ms(a, b) / reps


def read_metrics(metrics, run: Run) -> dict:
    out = {}
    for m in metrics:
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def set_up(cell: spec.Cell, seed: int, device, fault=None, parts=None):
    """The program's scene and step, its start state replicated to the
    cell's worlds, and the warm frames. Returns (scene, step, state after
    the warm frames, ProgramReadings with the start and first frame).
    `parts`, a dict, gets the seconds of each part on the host's clock,
    each ended by a synchronise: the kernel library's load (with its nvcc
    build in a checkout's first run, and then `built` is 1), the scene's
    build, the step's statics, the start state and the warm frames."""
    traffic = cell.traffic
    worlds, dt = int(traffic["worlds"]), float(traffic["dt"])
    device = torch.device(device)
    parts = {} if parts is None else parts
    clock = window.Clock(device)
    t = time.perf_counter()

    def part(name):
        nonlocal t
        clock.sync()
        now = time.perf_counter()
        parts[name] = now - t
        t = now

    if device.type == "cuda":
        from lumixengine_tpu_torch.ops import native

        parts["built"] = int(not native.library_path().exists())
        native.library()
    part("library_s")
    scene = scenes.build(cell.config, seed, device)
    part("scene_s")
    step = scene.build_step()
    if fault is not None:
        step = fault(step)
    part("statics_s")
    state = scene.start(worlds, seed)
    rows = check.sample_rows(worlds, seed)
    readings = ProgramReadings(worlds, seed, rows, tree.rows(tree.flatten(state), rows), None,
                               None, None)
    part("start_s")
    for _ in range(int(traffic["warm_frames"])):
        state = step(state, dt)
        if readings.first is None:
            readings.first = tree.rows(tree.flatten(state), rows)
    part("warm_s")
    return scene, step, state, readings


def judge(cell: spec.Cell, readings: ProgramReadings, seed: int, device, lower: bool = False):
    """The check against the reference: (numbers, world-frames compared,
    world-frames over a limit). With `lower`, the control's."""
    ref = check.Reference(cell.config, seed, device, cell.bench_dir)
    return check.verdict(check.stages(ref, readings, float(cell.traffic["dt"]), lower),
                         cell.config["limits"], log)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t0: float,
             fault=None, parts=None) -> dict:
    """One run of `cell` on `device`; the result's line as a dict. `t0` is
    the process's start on the host's clock. `fault`, for the harness's
    tests, wraps the program's step. `parts`: the set-up's parts measured
    before the call (the imports, CUDA's initialisation)."""
    device = torch.device(device)
    dt = float(cell.traffic["dt"])
    clock = window.Clock(device)
    parts = dict(parts or {"imports_s": time.perf_counter() - t0})
    scene, step, state, readings = set_up(cell, seed, device, fault, parts)
    clock.sync()
    setup_s = time.perf_counter() - t0
    log("set-up: " + ", ".join(f"{k} {v!r}" for k, v in parts.items()))
    if clock.cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    win = window.run(step, state, dt, seconds, clock)
    del state
    prev, last, step_trace = win.prev, win.state, None
    if traced:
        prev, last, step_trace = trace.trace_step(step, last, dt,
                                                  int(cell.traffic["trace_frames"]),
                                                  int(cell.traffic["labelled_frames"]), clock.sync,
                                                  clock.cuda)
    peak = window_peak = None
    if clock.cuda:
        window_peak = torch.cuda.max_memory_allocated(device)
        peak = max(setup_peak, window_peak)
    ms = sorted(win.frame_ms)
    log(f"window: {win.frames} frames in {win.seconds:.6f} s on the device "
        f"({win.host_seconds:.6f} s on the host's clock), set-up {setup_s:.6f} s, "
        f"{readings.worlds} worlds; ms a frame min {ms[0]:.3f} median {ms[len(ms) // 2]:.3f} "
        f"max {ms[-1]:.3f}")
    run = Run(cell, scene, step, clock, dt, setup_s, win, last, step_trace, window_peak)
    metrics = read_metrics(cell.per_layer if traced else cell.end_to_end, run)
    readings.prev, readings.last = tree.flatten(prev), tree.flatten(last)
    del run, win, prev, last, step, scene
    numbers, attempted, failed = judge(cell, readings, seed, device)
    limits = cell.config["limits"]
    correct = failed == 0 and all(v <= limits[k] for k, v in numbers.items())
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if clock.cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if clock.cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if step_trace is not None:
        result["device"].update(busy_s=step_trace.busy_s, window_s=step_trace.window_s)
        result["breakdown"] = {"device_ops": step_trace.device_ops,
                               "idle_gaps": step_trace.idle_gaps}
    result["setup_parts"] = parts
    result["compared"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return result


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once and print "
                                            "its result as the last line of standard output.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    t = time.perf_counter()
    parts = {"imports_s": t - t0}
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    parts["cuda_init_s"] = time.perf_counter() - t
    if found < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {found}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t0,
                      parts=parts)
    log(f"card: {card_line()}")
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"modules of the JAX side were loaded in this process: {loaded}")
        return 3
    for k, v in result["compared"].items():
        log(f"compared {k}: {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
