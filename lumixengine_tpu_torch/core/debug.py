"""Crash handling / debug (≙ reference core/debug.h + core/{win,linux}/debug.cpp).

Reference: callstack capture (StackTree), an unhandled-exception handler
installed at engine boot producing a crash report with the callstack + the
profiler stack (debug.cpp), debug-allocator guards, and
enableFloatingPointTraps.

The port's copy of ``lumixengine_tpu/core/debug.py``: a sys.excepthook that
writes a crash report (traceback + recent log ring + profiler counters +
device info), and floating-point traps. The reference's traps turn on JAX's
NaN debugging, so a computation that makes a NaN raises
``FloatingPointError``. PyTorch has no such global switch; here, while the
traps are on, the step ``Engine.build_step`` returns checks every floating
tensor of the state it returns and raises ``FloatingPointError`` naming the
fields that hold a NaN. That costs one host sync a step while on and
nothing while off (the default)."""
from __future__ import annotations

import datetime
import os
import sys
import traceback
from typing import Optional

from lumixengine_tpu_torch.core import log, profiler

_installed = False
_report_dir = "."
_fp_traps = False


def enable_floating_point_traps(on: bool = True) -> None:
    """≙ debug.h enableFloatingPointTraps: while on, an engine step whose
    state holds a NaN raises FloatingPointError naming its fields."""
    global _fp_traps
    _fp_traps = bool(on)


def floating_point_traps_enabled() -> bool:
    return _fp_traps


def _floating_fields(x, name: str, out: list) -> None:
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            out.append((name, x))
    elif isinstance(x, dict):
        for k, v in x.items():
            _floating_fields(v, f"{name}.{k}" if name else str(k), out)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _floating_fields(getattr(x, f.name), f"{name}.{f.name}" if name else f.name, out)


def check_floating_point(state) -> None:
    """Raise FloatingPointError naming the floating fields of `state`
    (nested dataclasses and dicts of tensors) that hold a NaN, the first
    found first. One host sync for the whole state."""
    import torch

    fields: list = []
    _floating_fields(state, "", fields)
    if not fields:
        return
    dev = fields[0][1].device
    hits = torch.stack([torch.isnan(t).any().to(dev) for _, t in fields]).cpu()
    bad = [fields[int(i)][0] for i in torch.nonzero(hits).flatten()]
    if bad:
        raise FloatingPointError(f"NaN in {', '.join(bad)}")


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
