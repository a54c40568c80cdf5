#!/usr/bin/env python3
"""Run chip_smoke.py's phase 15 alone on one NVIDIA GPU: the flagship's
frames under each PhysicsModule solver_backend (auto, pallas, jnp) with
K2's launches and the jnp state's gap to auto; the slot step's classic
tier on the 10k-box drop; the hierarchy propagations in entity order
against propagate_plan; culling_system.cull (K1 bit for bit with its plain
version); skinning on the ybot-size character; and the floating-point
traps; each time with the card's name and power limit.

    python tools/surface_tier.py
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
        print("surface_tier: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.ops import native

    dev = torch.device(C.DEVICE)
    card = C.gpu_line()
    C.log(f"[15 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    native.library()
    t0 = time.perf_counter()
    C.run_surface_tier(dev, card)
    C.log(f"[15 time] phase 15: {time.perf_counter() - t0:.1f} s of the host's clock; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
