#!/usr/bin/env python3
"""Where the card and the CPU part on the sap pile (physics_scenes.mixed_pile
at 256 actors under broadphase="sap", W=4, the worlds of replicate_scene
seed 1): both run free from one start for --steps steps, and at each step
the line gives the free runs' largest local.pos gap (and its world and
entity), the one-step gap of the CPU stepping the card's state (lockstep),
the contact slots whose active flag the two devices decide apart on that
state, those the free runs decide apart on their own states (with the
largest depth among them), the slots active in both whose point or
normal they pick more than 1 mm apart (with the largest depth difference
among them), and the sleep counters that differ between the free runs. Also the
gap between starts drawn by each device's own generator, and the CPU's
free run from a start nudged by N(0, eps²) m, for each --nudge.

    python tools/sap_divergence.py [--steps 30]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--nudge", type=float, nargs="*", default=[1e-6, 1e-4])
    ap.add_argument("--device", default="cuda", help="cpu: a dry run, the CPU against itself")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sap_divergence: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as C
    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.models import physics_scenes as PS

    cuda, dt = torch.device(args.device), 1.0 / 60.0
    print(C.gpu_line() if args.device == "cuda" else "cpu", flush=True)
    sc = PS.mixed_pile(actors=256, broadphase="sap", neighbors=32)
    pm = sc.world.modules["physics"]
    step, cpu_step = sc.engine.build_step(sc.world, cuda), sc.engine.build_step(sc.world, "cpu")

    def start(dev):
        return PS.replicate_scene(sc.world.device_state(dev), 4, seed=1)

    def where(a, b, key="local.pos"):
        d = np.abs(a[key] - b[key])
        i = np.unravel_index(int(d.argmax()), d.shape)
        return float(d.max()), [int(x) for x in i]

    own = bridge.state_to_numpy(start(cuda).to("cpu"))
    gap0 = where(own, bridge.state_to_numpy(start(torch.device("cpu"))))
    print(json.dumps({"starts_from_each_device_generator": gap0}), flush=True)

    g, c = start(cuda), start(cuda).to("cpu")
    for i in range(args.steps):
        gn, cn = bridge.state_to_numpy(g), bridge.state_to_numpy(c)
        one = bridge.state_to_numpy(cpu_step(g.to("cpu"), dt))
        g_next = step(g, dt)
        lock = where(bridge.state_to_numpy(g_next), one)
        flags = int((pm._contact_stage(g, dt).contacts.active.cpu()
                     != pm._contact_stage(g.to("cpu"), dt).contacts.active).sum())
        # each free run's own contact set: the slots decided apart, and the
        # largest depth among them (about 0: a touch decided at its threshold)
        fg, fc = pm._contact_stage(g, dt).contacts, pm._contact_stage(c, dt).contacts
        apart = (fg.active.cpu() != fc.active)
        depth = torch.maximum(fg.depth.cpu().abs(), fc.depth.abs())[apart]
        # slots active in both whose point or normal the free runs pick apart
        # (another vertex or axis, as at a tie), with their depths' difference
        both = fg.active.cpu() & fc.active
        moved = torch.maximum((fg.point.cpu() - fc.point).abs().amax(dim=-2),
                              (fg.normal.cpu() - fc.normal).abs().amax(dim=-2)) > 1e-3
        picked = both & moved
        ddepth = (fg.depth.cpu() - fc.depth).abs()[picked]
        print(json.dumps({"step": i, "free_gap": where(gn, cn), "free_vel_gap": where(gn, cn, PS.PH + "vel")[0],
                          "lockstep_gap": lock, "flags_apart": flags,
                          "free_flags_apart": int(apart.sum()),
                          "free_flags_depth": float(depth.max()) if depth.numel() else None,
                          "free_picks_apart": int(picked.sum()),
                          "free_picks_depth_gap": float(ddepth.max()) if ddepth.numel() else None,
                          "sleep_apart": int((gn[PS.PH + "sleep"] != cn[PS.PH + "sleep"]).sum()),
                          "entity_y": [float(gn["local.pos"][w, 1, e])
                                       for w, _a, e in [where(gn, cn)[1]]]}),
              flush=True)
        g, c = g_next, cpu_step(c, dt)
    base = bridge.state_to_numpy(c)
    for eps in args.nudge:
        s0 = start(cuda).to("cpu")
        nudge = torch.randn(s0.local.pos.shape, generator=torch.Generator().manual_seed(2)) * eps
        s = s0.replace(local=s0.local.replace(pos=s0.local.pos + nudge))
        for _ in range(args.steps):
            s = cpu_step(s, dt)
        print(json.dumps({"cpu_nudged": eps, "free_gap": where(bridge.state_to_numpy(s), base)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
