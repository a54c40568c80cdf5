#!/usr/bin/env python3
"""Run chip_smoke.py's phase 10 alone on one NVIDIA GPU: the sap pile
(broadphase="sap"), the stand-alone steps on the elongated pile and the 10k
boxes, the banded farm at its widths and the layered crowd, each checked
and timed as in the whole script, with the card's name and power limit;
and phase 7's banded props level ("props"). The piles, the banded farm and
the level run at their full depth here (the piles' 320 steps with their
settle gates, the farm's 60, the level's 360 with its settle bounds), which
the whole script cuts.

    python tools/sim_tier.py [--only sap piles farm layered props]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as C

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=["sap", "piles", "farm", "layered", "props"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sim_tier: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.engine.world import map_tensors
    from lumixengine_tpu_torch.ops import native
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    C.FULL_DEPTH = True
    dev = torch.device(C.DEVICE)
    card = C.gpu_line()
    C.log(f"[10 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    native.library()
    t0 = time.perf_counter()
    runs = {"sap": lambda: C.run_sap_pile(dev, card), "piles": lambda: C.run_pile_steps(dev, card),
            "farm": lambda: C.run_banded_farm(dev, card),
            "layered": lambda: C.run_layered(dev, card, replicate_state, map_tensors),
            "props": lambda: C.run_banded_props(dev, card)}
    for name in args.only:
        t1 = time.perf_counter()
        runs[name]()
        C.log(f"[10 time] {name}: {time.perf_counter() - t1:.1f} s of the host's clock")
    C.log(f"[10 time] phase 10: {time.perf_counter() - t0:.1f} s; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
