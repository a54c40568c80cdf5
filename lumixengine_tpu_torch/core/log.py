"""Logging (≙ reference core/log.{h,cpp} + log_callback.h).

Callback fan-out with levels; the engine installs a file sink with
flush-on-error (≙ engine.cpp log-to-file), tests install a console sink,
the (future) editor a UI sink. A ring of recent messages backs crash reports
(core/debug.py).
"""
from __future__ import annotations

import sys
import time
from collections import deque
from typing import Callable, Deque, List, Tuple

LOG_INFO = 0
LOG_WARNING = 1
LOG_ERROR = 2

_LEVEL_NAMES = {LOG_INFO: "INFO", LOG_WARNING: "WARN", LOG_ERROR: "ERROR"}

_callbacks: List[Callable[[int, str, str], None]] = []
recent: Deque[Tuple[float, int, str, str]] = deque(maxlen=256)


def register_callback(cb: Callable[[int, str, str], None]) -> None:
    _callbacks.append(cb)


def unregister_callback(cb) -> None:
    if cb in _callbacks:
        _callbacks.remove(cb)


def _emit(level: int, system: str, message: str) -> None:
    recent.append((time.time(), level, system, message))
    for cb in list(_callbacks):
        cb(level, system, message)


def log_info(system: str, message: str) -> None:
    _emit(LOG_INFO, system, message)


def log_warning(system: str, message: str) -> None:
    _emit(LOG_WARNING, system, message)


def log_error(system: str, message: str) -> None:
    _emit(LOG_ERROR, system, message)


def console_sink(level: int, system: str, message: str) -> None:
    stream = sys.stderr if level >= LOG_WARNING else sys.stdout
    stream.write(f"[{_LEVEL_NAMES[level]}] {system}: {message}\n")


class FileSink:
    """≙ engine.cpp file log with flush-on-error."""

    def __init__(self, path: str):
        self._f = open(path, "a", buffering=1)

    def __call__(self, level: int, system: str, message: str) -> None:
        self._f.write(f"{time.strftime('%H:%M:%S')} [{_LEVEL_NAMES[level]}] {system}: {message}\n")
        if level >= LOG_ERROR:
            self._f.flush()

    def close(self) -> None:
        self._f.close()
