#!/usr/bin/env python3
"""The PhysicsModule's banded branch on a block of boxes (the bench's grid,
``models/physics_scenes.box_block``) at several sweep windows
(``PhysicsModule.sap_neighbors``): for each window the window certificate
``sap_window_miss`` summed over the run (0: no overlapping pair fell outside
every sweep's window), the first step that missed, wall-clock ms/step (the
counters stay on the device until the end), and the lowest box centre.

    python tools/banded_window.py                        # 10,000 boxes on the card
    python tools/banded_window.py --device cpu --boxes 64 --capacity 320 --steps 20
    # the JAX package's PhysicsModule on the same block, on the CPU:
    JAX_PLATFORMS=cpu python tools/banded_window.py --reference --boxes 1000 --capacity 1024
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(boxes: int, capacity: int, window: int, steps: int, device):
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS

    engine, world = PS.box_block(boxes, capacity, neighbors=window)
    pm = world.modules["physics"]
    assert pm.statics().sap, "the block did not take the banded branch"
    step = engine.build_step(world, device)
    state = world.device_state(device)
    per_step = []
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state, PS.DT)
        per_step.append(state.modules["physics"].counters["sap_window_miss"])
    misses = torch.stack(per_step).cpu().tolist()
    wall = time.perf_counter() - t0
    occ = torch.as_tensor(pm.statics().occupied, device=device)
    lowest = float(state.modules["physics"].pos[1][occ].min())
    first = next((i + 1 for i, m in enumerate(misses) if m), None)
    return {"package": "torch", "window": window, "miss": int(sum(misses)), "first_miss_step": first,
            "ms_per_step": wall / steps * 1e3, "lowest": lowest}


def run_reference(boxes: int, capacity: int, window: int, steps: int):
    """The same block through the JAX package's PhysicsModule (jitted step)."""
    import jax.numpy as jnp
    import jax
    import numpy as np

    from lumixengine_tpu.engine.engine import Engine
    from lumixengine_tpu.physics.module import PhysicsSystem

    engine = Engine()
    engine.module_capacities = {"actors": capacity, "joints": 1}
    engine.add_system(PhysicsSystem(engine))
    world = engine.create_world(capacity=capacity + 8)
    rng = np.random.default_rng(0)
    side = int(np.ceil(boxes ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    for p in (grid[:boxes] * 1.1 + rng.uniform(0, 0.05, (boxes, 3)) + [0.0, 2.0, 0.0]
              ).astype(np.float32):
        e = world.create_entity(position=tuple(float(x) for x in p))
        world.create_component(e, "rigid_actor", motion="dynamic", shape="box",
                               half_extents=(0.5, 0.5, 0.5), mass=1.0, friction=0.6)
    pm = world.modules["physics"]
    pm.sap_neighbors = window
    pm.invalidate_statics()
    assert pm.statics().sap, "the block did not take the banded branch"
    step = jax.jit(engine.build_step(world, jit=False))
    state = world.device_state()
    misses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state, jnp.float32(1.0 / 60.0))
        misses.append(int(state.modules["physics"].counters["sap_window_miss"]))
    wall = time.perf_counter() - t0
    lowest = float(np.asarray(state.modules["physics"].pos)[1][pm.statics().occupied].min())
    first = next((i + 1 for i, m in enumerate(misses) if m), None)
    return {"package": "jax", "window": window, "miss": sum(misses), "first_miss_step": first,
            "ms_per_step": wall / steps * 1e3, "lowest": lowest}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--boxes", type=int, default=10_000)
    ap.add_argument("--capacity", type=int, default=10_240)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--windows", type=int, nargs="+", default=[16, 24, 32, 40])
    ap.add_argument("--reference", action="store_true",
                    help="run the JAX package's PhysicsModule instead (on its default backend)")
    a = ap.parse_args()
    for w in a.windows:
        if a.reference:
            print(run_reference(a.boxes, a.capacity, w, a.steps), flush=True)
        else:
            print(run(a.boxes, a.capacity, w, a.steps, a.device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
