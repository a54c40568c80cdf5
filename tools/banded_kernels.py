#!/usr/bin/env python3
"""Run chip_smoke.py's checks of the two banded kernels alone on one NVIDIA
GPU: the 10k-box drop at W=4 stepped 60 frames through the engine (BJ's and
BG's launches counted each frame), then BJ (csrc/banded_jacobi.cu) and BG
(csrc/banded_grids.cu) against their plain versions on the next frame's
operands and timed beside their bounds; with what ptxas reports for BG and
the card's name and power limit.

    python tools/banded_kernels.py
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
        print("banded_kernels: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.ops import native

    dev = torch.device(C.DEVICE)
    card = C.gpu_line()
    C.log(f"[6 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    native.library()
    for line in C.ptxas_report(native.build_log()):
        if line.startswith(("BG", "BJ")):
            C.log(f"[2 ptxas] {line}")
    t0 = time.perf_counter()
    ops = C.box_drop_operands(dev)
    C.check_banded_jacobi(card, ops)
    C.check_banded_grids(card, ops)
    C.log(f"[6 time] the banded kernels: {time.perf_counter() - t0:.1f} s of the host's clock; "
          f"{card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
