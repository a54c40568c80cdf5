"""The host-side native library of the navigation path (counterpart of
``lumixengine_tpu/utils/native.py``): the grid A* of ``csrc/nav_astar.cpp``,
shared with the JAX package as it is, built with ``g++`` at first use into
``lumixengine_tpu_torch/_build/`` and bound with ``ctypes``.

If ``g++`` or the build fails, ``available()`` is False and the caller
(``NavZone.find_path``) runs its Python A*, which gives the same path.
Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "csrc" / "nav_astar.cpp"
_OUT = Path(__file__).resolve().parent.parent / "_build" / "libnav_astar.so"

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        if _OUT.exists() and _OUT.stat().st_mtime >= _SRC.stat().st_mtime:
            return True
        _OUT.parent.mkdir(parents=True, exist_ok=True)
        # build beside the target and rename: concurrent builders never load a partial file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_OUT.parent)
        os.close(fd)
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _OUT)
        return True
    except Exception:
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_OUT))
            lib.lxt_nav_astar.restype = ctypes.c_int
            lib.lxt_nav_astar.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def nav_astar(walkable, sx: int, sz: int, gx: int, gz: int, max_cells: int = 65536):
    """Native grid A* (≙ Detour findPath). walkable: bool [H, W].
    Returns int32 [L, 2] (x, z) cells start→goal, or None."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native pathfinder unavailable")
    w8 = np.ascontiguousarray(walkable, dtype=np.uint8)
    h, w = w8.shape
    out = (ctypes.c_int32 * (2 * max_cells))()
    n = lib.lxt_nav_astar(w8.tobytes(), w, h, int(sx), int(sz), int(gx), int(gz),
                          out, max_cells)
    if n < 0:
        return None
    return np.ctypeslib.as_array(out)[: 2 * n].reshape(n, 2).copy()
