"""Build and load the hand-written Hopper kernels in ``csrc/``.

The ``.cu`` sources have a plain C interface. At first use they are compiled
with ``nvcc`` for ``sm_90a`` into one shared library under
``lumixengine_tpu_torch/_build/``, whose file name carries a hash of the
sources and flags (a source change rebuilds), and loaded with ``ctypes``. What ``ptxas -v`` reports for each kernel (registers, shared
memory, spills) is kept beside the library (``build_log``).
Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("cull.cu", "solver.cu", "threefry.cu", "banded_jacobi.cu", "banded_grids.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_I64 = ctypes.c_longlong


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"liblumix_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library if this version of the sources has not
    been built yet; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """nvcc's output for the built library: ptxas' registers, shared memory
    and spills per kernel."""
    log = build().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    lib = ctypes.CDLL(str(build()))
    lib.lumix_frustum_cull.argtypes = [_P, _P, _P, _P, _I, _I, _P]
    lib.lumix_frustum_cull.restype = _I
    lib.lumix_solve_contacts.argtypes = [_P] * 31 + [_I] * 11 + [_P]
    lib.lumix_solve_contacts.restype = _I
    lib.lumix_solve_contacts_smem.argtypes = [_I] * 4
    lib.lumix_solve_contacts_smem.restype = ctypes.c_size_t
    lib.lumix_threefry_fold.argtypes = [_P, _I, _I, _P, _I, _I, _U32, _P, _I64, _P]
    lib.lumix_threefry_fold.restype = _I
    lib.lumix_threefry_draw.argtypes = [_P, _I, _I, _P, _I, _I, _U32, _I, _I, _P, _I64, _I64, _P]
    lib.lumix_threefry_draw.restype = _I
    lib.lumix_banded_jacobi_abi.argtypes = [_P]
    lib.lumix_banded_jacobi_abi.restype = None
    lib.lumix_banded_jacobi_workspace.argtypes = [_I] * 7
    lib.lumix_banded_jacobi_workspace.restype = _I64
    lib.lumix_banded_jacobi.argtypes = [_P, _P]
    lib.lumix_banded_jacobi.restype = _I
    lib.lumix_banded_grids_abi.argtypes = [_P]
    lib.lumix_banded_grids_abi.restype = None
    lib.lumix_banded_grids.argtypes = [_P, _P, _P]
    lib.lumix_banded_grids.restype = _I
    return lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def check_operands(device: torch.device, **tensors) -> None:
    """Every operand on `device`, contiguous; raises otherwise."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
