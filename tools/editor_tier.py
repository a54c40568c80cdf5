#!/usr/bin/env python3
"""Run chip_smoke.py's phase 14 alone on one NVIDIA GPU: phase 12's stress
scene written as a .unv beside the assets of phase 13 and opened by the
editor (EditorApp) on the card; a fixed key script through every view, the
scene view's paused (dt = 0) and playing frames around a physics-view layer
edit, undo and redo, the world saved as .unv and reloaded; the same script
on the CPU against the card; K1 and K2 against their plain versions on the
path's operands; and parallel/dryrun.py with two shards on the card; each
time with the card's name and power limit.

    python tools/editor_tier.py
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
        print("editor_tier: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.ops import native

    dev = torch.device(C.DEVICE)
    card = C.gpu_line()
    C.log(f"[14 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    native.library()
    t0 = time.perf_counter()
    C.run_editor_tier(dev, card)
    C.log(f"[14 time] phase 14: {time.perf_counter() - t0:.1f} s of the host's clock; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
