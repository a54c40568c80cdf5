#!/usr/bin/env python3
"""Run chip_smoke.py's phase 13 alone on one NVIDIA GPU: the assets of
models/asset_scenes.py (a skinned FBX character with its take, three FBX
props with .meta sidecars, a .mat, an .ltc graph, the take as an .anm) and
the stress scene on them, written as a .unv; each FBX parsed; the assets
compiled through the AssetCompiler attached to the engine, a rewritten .mat
recompiled by one Engine.update_host; Runner.load_world on the card with no
placeholder, 60 ticks with K1 and K2 counted, 3 ticks card vs CPU, the
on-device present of the FBX meshes card vs CPU, the game view's play and
stop, the animation graph, particle and voxelizer editors, and app.main
--tui; each time with the card's name and power limit.

    python tools/asset_tier.py
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
        print("asset_tier: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.ops import native

    dev = torch.device(C.DEVICE)
    card = C.gpu_line()
    C.log(f"[13 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    native.library()
    t0 = time.perf_counter()
    C.run_asset_tier(dev, card)
    C.log(f"[13 time] phase 13: {time.perf_counter() - t0:.1f} s of the host's clock; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
