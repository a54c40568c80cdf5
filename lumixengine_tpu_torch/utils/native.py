"""The host-side native libraries (counterpart of
``lumixengine_tpu/utils/native.py``): the LZ4 block codec of
``csrc/lz4_codec.cpp`` (world blobs, checkpoints, ``.unv`` bodies and
``.nav`` tiles), the grid A* of ``csrc/nav_astar.cpp`` (navigation) and the
z-buffered triangle fill of ``csrc/soft_raster.cpp`` (the software present's
raster), all shared with the JAX package as they are, each built with
``g++`` at first use into ``lumixengine_tpu_torch/_build/`` and bound with
``ctypes``.

If ``g++`` or a build fails, ``lz4_available()`` (the codec),
``available()`` (the A*) or ``raster_available()`` (the fill) is False: the
world blob then names ``zlib`` as its codec (the reference's own rule), and
the A* and the fill run their Python versions, which give the same result.
A ``.unv`` body or a ``.nav`` tile is LZ4 by format and cannot be read
without the codec. Nothing is built when this module is imported.
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
_BUILD = Path(__file__).resolve().parent.parent / "_build"

_lock = threading.Lock()
_libs: dict = {}


def _bind_nav(lib) -> None:
    lib.lxt_nav_astar.restype = ctypes.c_int
    lib.lxt_nav_astar.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]


def _bind_raster(lib) -> None:
    fp = ctypes.POINTER(ctypes.c_float)
    lib.lxt_raster_tris.restype = ctypes.c_int
    lib.lxt_raster_tris.argtypes = [fp, fp, ctypes.c_int, ctypes.c_int, fp, fp, fp, ctypes.c_int]


def _bind_lz4(lib) -> None:
    lib.lxt_lz4_bound.restype = ctypes.c_int
    lib.lxt_lz4_bound.argtypes = [ctypes.c_int]
    for fn in (lib.lxt_lz4_compress, lib.lxt_lz4_decompress):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]


# library name → (source under csrc/, binder)
_SOURCES = {"lz4_codec": ("lz4_codec.cpp", _bind_lz4),
            "nav_astar": ("nav_astar.cpp", _bind_nav),
            "soft_raster": ("soft_raster.cpp", _bind_raster)}


def _build(src: Path, out: Path) -> bool:
    try:
        if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
            return True
        out.parent.mkdir(parents=True, exist_ok=True)
        # build beside the target and rename: concurrent builders never load a partial file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(src), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except Exception:
        return False


def _load(name: str):
    with _lock:
        if name in _libs:
            return _libs[name]
        src, bind = _SOURCES[name]
        out = _BUILD / f"lib{name}.so"
        lib = None
        if _build(_ROOT / "csrc" / src, out):
            try:
                lib = ctypes.CDLL(str(out))
                bind(lib)
            except OSError:
                lib = None
        _libs[name] = lib
        return lib


def lz4_available() -> bool:
    """The LZ4 codec library built and loaded."""
    return _load("lz4_codec") is not None


def lz4_compress(data: bytes) -> bytes:
    """One LZ4 block of `data` (the reference's world-blob codec)."""
    lib = _load("lz4_codec")
    if lib is None:
        raise RuntimeError("native codec unavailable")
    bound = lib.lxt_lz4_bound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = lib.lxt_lz4_compress(data, len(data), out, bound)
    if n < 0:
        raise RuntimeError("lz4 compress failed")
    return out.raw[:n]


def lz4_decompress(data: bytes, raw_size: int) -> bytes:
    """The `raw_size` bytes of one LZ4 block."""
    lib = _load("lz4_codec")
    if lib is None:
        raise RuntimeError("native codec unavailable")
    out = ctypes.create_string_buffer(raw_size)
    n = lib.lxt_lz4_decompress(data, len(data), out, raw_size)
    if n != raw_size:
        raise RuntimeError(f"lz4 decompress failed ({n} != {raw_size})")
    return out.raw


def available() -> bool:
    """The A* library built and loaded."""
    return _load("nav_astar") is not None


def raster_available() -> bool:
    """The triangle-fill library built and loaded."""
    return _load("soft_raster") is not None


def nav_astar(walkable, sx: int, sz: int, gx: int, gz: int, max_cells: int = 65536):
    """Native grid A* (≙ Detour findPath). walkable: bool [H, W].
    Returns int32 [L, 2] (x, z) cells start→goal, or None."""
    lib = _load("nav_astar")
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


def raster_tris(fb: np.ndarray, zb: np.ndarray, tv, tz, cols) -> int:
    """Z-buffered fill of T screen-space triangles into fb [H, W, 3] and
    zb [H, W] (float32, C-contiguous, mutated in place): tv [T, 3, 2]
    screen xy, tz [T, 3] view depth, cols [T, 3] rgb. Returns the pixels
    written."""
    lib = _load("soft_raster")
    if lib is None:
        raise RuntimeError("native rasterizer unavailable")
    if fb.dtype != np.float32 or zb.dtype != np.float32 \
            or not (fb.flags.c_contiguous and zb.flags.c_contiguous):
        raise ValueError("fb and zb must be C-contiguous float32")
    h, w = zb.shape
    tv = np.ascontiguousarray(tv, np.float32)
    tz = np.ascontiguousarray(tz, np.float32)
    cols = np.ascontiguousarray(cols, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    return lib.lxt_raster_tris(fb.ctypes.data_as(fp), zb.ctypes.data_as(fp), w, h,
                               tv.ctypes.data_as(fp), tz.ctypes.data_as(fp),
                               cols.ctypes.data_as(fp), len(tz))
