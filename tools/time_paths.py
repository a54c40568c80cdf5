#!/usr/bin/env python
"""Time the port's frame paths that chip_smoke.py times, from one checkout,
so that two commits can be compared on one card in one call.

    python tools/time_paths.py [--root DIR] [--frames 100] [--box-steps 300]
                               [--paths flagship,slice,crowd,particles,boxes]

Imports lumixengine_tpu_torch from --root (default: this checkout) and builds
each path as chip_smoke.py phases 5 and 6 do, with the same seeds and W:
the flagship full_frame_world(10240, 64, 64, 2048) at W=1024, the slice
full_frame_world(10240, 0, 64, 0) at W=256, the skinned crowd
skinned_crowd_world(256) at W=1024, the particle storm
particle_stress_world(1_000_000) at W=1, each through
Engine.build_step(extra=cull_pass) for --frames frames with the first 10
untimed; and the 10k-box drop box_drop_pile(10_000), --box-steps steps to
warm up and --box-steps timed. Times are CUDA events around the loop. It
prints one JSON line: the card's name and power limit, --root, and ms a
frame (a step for the boxes) per path. Needs a CUDA device and nvcc.

To compare a parent commit with the working tree, unpack the parent into an
ignored directory and time parent, change, change, parent:

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    for r in _archive/parent . . _archive/parent; do python tools/time_paths.py --root $r; done
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

WARM = 10
DT = 1.0 / 60.0
PATHS = {   # name: (builder, arguments, worlds), as chip_smoke.py runs them
    "flagship": ("full_frame_world", (10240, 64, 64, 2048), 1024),
    "slice": ("full_frame_world", (10240, 0, 64, 0), 256),
    "crowd": ("skinned_crowd_world", (256,), 1024),
    "particles": ("particle_stress_world", (1_000_000,), 1),
}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_frames(step, state, frames: int) -> float:
    """ms a frame of `step` over frames WARM..frames, with CUDA events."""
    import torch

    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for f in range(frames):
        if f == WARM:
            ev0.record()
        state = step(state, DT)
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / (frames - WARM)


def time_boxes(demo_scenes, dev, steps: int) -> float:
    """ms a step of the 10k-box drop over `steps` steps after `steps` to warm up."""
    import torch

    step, (pos, rot, vel, ang, carry), consts = demo_scenes.box_drop_pile(10_000, device=dev)
    dt = torch.tensor(DT, dtype=torch.float32, device=dev)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(2 * steps):
        if i == steps:
            ev0.record()
        pos, rot, vel, ang, _ctr, carry = step(pos, rot, vel, ang, dt, carry, consts)
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--box-steps", type=int, default=300)
    ap.add_argument("--paths", default=",".join([*PATHS, "boxes"]))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_paths: no CUDA device", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.models import demo_scenes
    from lumixengine_tpu_torch.ops import native
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    dev = torch.device("cuda:0")
    native.library()
    ms = {}
    for name in args.paths.split(","):
        if name == "boxes":
            ms[name] = time_boxes(demo_scenes, dev, args.box_steps)
            continue
        builder, build_args, worlds = PATHS[name]
        built = getattr(demo_scenes, builder)(*build_args)
        engine, world = built[0], built[1]
        step = engine.build_step(world, dev, extra=world.modules["renderer"].cull_pass)
        state = replicate_state(world.device_state(dev), worlds,
                                torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        ms[name] = time_frames(step, state, args.frames)
        del state, step, built, engine, world
        torch.cuda.empty_cache()
    print(json.dumps({"card": gpu_line(), "root": args.root, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
