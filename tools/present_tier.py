#!/usr/bin/env python3
"""Run chip_smoke.py's phase 11 alone on one NVIDIA GPU: app.main's path
(headless_demo_world(2048) through the Runner, 60 ticks), present() with
the builtin plugins and present_tpu() at 480x270 and 1280x720, each timed,
counted and checked against the CPU as in the whole script, with the card's
name and power limit.

    python tools/present_tier.py
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
        print("present_tier: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.ops import native

    dev = torch.device(C.DEVICE)
    card = C.gpu_line()
    C.log(f"[11 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    native.library()
    t0 = time.perf_counter()
    C.run_present(dev, card)
    C.log(f"[11 time] phase 11: {time.perf_counter() - t0:.1f} s of the host's clock; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
