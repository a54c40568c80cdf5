#!/usr/bin/env python3
"""Run chip_smoke.py's phase 12 alone on one NVIDIA GPU: the stress scene
(models/host_scenes.py) written as a .unv, loaded with Runner.load_world on
the card and started, 60 ticks with K1 and K2 counted, the same load and 3
ticks on the CPU against the card, the world blob reloaded into a fresh
engine, a checkpoint resumed bit for bit, export_scene back to the scene,
and the per-phase cost model beside each phase's device time; each time
with the card's name and power limit.

    python tools/host_tier.py
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("host_tier: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.ops import native

    dev = torch.device(C.DEVICE)
    card = C.gpu_line()
    C.log(f"[12 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    native.library()
    t0 = time.perf_counter()
    C.run_host_tier(dev, card)
    C.log(f"[12 time] phase 12: {time.perf_counter() - t0:.1f} s of the host's clock; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
