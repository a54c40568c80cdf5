#!/usr/bin/env python3
"""Run chip_smoke.py's phase 16 alone on one NVIDIA GPU: reflected property
edits (model instances re-pointed on the headless demo, the flagship's
animables' clip and time_scale and animators' controller) reaching the render
and animation statics, card against CPU; RenderModule.set_model and
AnimationModule.set_animator_input; the palette's cost as ms a frame with
build_palettes on and off; K1 and K2 against their plain versions on the
phase's operands; each time with the card's name and power limit.

    python tools/members_tier.py
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
        print("members_tier: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.ops import native

    dev = torch.device(C.DEVICE)
    card = C.gpu_line()
    C.log(f"[16 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    native.library()
    t0 = time.perf_counter()
    C.run_members_tier(dev, card)
    C.log(f"[16 time] phase 16: {time.perf_counter() - t0:.1f} s of the host's clock; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
