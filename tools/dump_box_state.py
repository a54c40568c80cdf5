#!/usr/bin/env python
"""Run the PyTorch port's 10k-box drop (`box_drop_pile`) for a number of
steps and save the body state and the step's carry as a compressed .npz.

    python tools/dump_box_state.py --device cuda --steps 1200 --out boxes_step1200.npz

The saved state is what `tests/test_torch_slots.py` steps with the JAX
package and the port side by side (`tests/data/boxes_step1200.npz` was made
by this script on an NVIDIA H100 at the defaults). Keys: pos, rot, vel,
angvel, carry0 .. carry5 (the slot step's 6-tuple carry), steps, and the
slot_drop / column_miss certificates summed over the run.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--bodies", type=int, default=10_000)
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--out", required=True)
    args = p.parse_args()

    import numpy as np
    import torch

    from lumixengine_tpu_torch.models.demo_scenes import box_drop_pile

    dev = torch.device(args.device)
    step, (pos, rot, vel, ang, carry), consts = box_drop_pile(args.bodies, device=dev)
    dt = torch.tensor(1.0 / 60.0, dtype=torch.float32, device=dev)
    drop = miss = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(args.steps):
        pos, rot, vel, ang, ctr, carry = step(pos, rot, vel, ang, dt, carry, consts)
        drop = drop + ctr["slot_drop"]
        miss = miss + ctr["column_miss"]
    arrays = {"pos": pos, "rot": rot, "vel": vel, "angvel": ang,
              **{f"carry{i}": c for i, c in enumerate(carry)},
              "slot_drop": drop, "column_miss": miss}
    np.savez_compressed(args.out, steps=np.int64(args.steps),
                        **{k: v.cpu().numpy() for k, v in arrays.items()})
    print(f"{args.steps} steps of {args.bodies} boxes on {dev}: slot_drop {int(drop)}, "
          f"column_miss {int(miss)}, sleeping {int(ctr['sleeping'])}, lowest centre "
          f"{float(pos[1].min()):.6f} m -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
