"""Crash handling / debug (≙ reference core/debug.h + core/{win,linux}/debug.cpp).

Reference: callstack capture (StackTree), an unhandled-exception handler
installed at engine boot producing a crash report with the callstack + the
profiler stack (debug.cpp), debug-allocator guards, and
enableFloatingPointTraps.

The port's copy of ``lumixengine_tpu/core/debug.py``: a sys.excepthook that
writes a crash report (traceback + recent log ring + profiler counters +
device info)."""
from __future__ import annotations

import datetime
import os
import sys
import traceback
from typing import Optional

from lumixengine_tpu_torch.core import log, profiler

_installed = False
_report_dir = "."


def write_crash_report(exc_type, exc, tb, path: Optional[str] = None) -> str:
    path = path or os.path.join(
        _report_dir, f"crash_{datetime.datetime.now():%Y%m%d_%H%M%S}.txt"
    )
    lines = ["=== lumixengine_tpu_torch crash report ===", ""]
    lines += traceback.format_exception(exc_type, exc, tb)
    lines += ["", "--- recent log ---"]
    for t, lvl, system, msg in list(log.recent)[-64:]:
        lines.append(f"[{lvl}] {system}: {msg}")
    lines += ["", "--- profiler blocks (tail) ---"]
    for name, t0, t1, tid in profiler.blocks()[-32:]:
        lines.append(f"{name}: {(t1 - t0) * 1e3:.2f} ms")
    try:
        import torch

        lines += ["", f"torch: {torch.__version__} cuda {torch.version.cuda}",
                  f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}"]
    except Exception:
        pass
    with open(path, "w") as f:
        f.write("\n".join(str(x) for x in lines))
    return path


def install_crash_handler(report_dir: str = ".") -> None:
    """≙ engine.cpp installing the unhandled-exception handler at boot."""
    global _installed, _report_dir
    _report_dir = report_dir
    if _installed:
        return
    _installed = True
    prev = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            path = write_crash_report(exc_type, exc, tb)
            log.log_error("crash", f"crash report written to {path}")
        finally:
            prev(exc_type, exc, tb)

    sys.excepthook = hook
