"""Build and load the port's CUDA kernels.

All sources under ``directtrajopt_tpu_torch/csrc/`` are compiled by ``nvcc``
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, into ``directtrajopt_tpu_torch/_build/``, and
is keyed by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads the existing library.

Flags: ``sm_90a`` (Hopper), ``-O3``, and *no* fast math — the kernels rely
on correctly rounded division and square root (nvcc's defaults
``-prec-div=true -prec-sqrt=true -ftz=false``).

Every kernel wrapper counts its launches in :data:`LAUNCHES`, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["LAUNCHES", "reset_launches", "library", "build_info", "stream_ptr"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

LAUNCHES = {"factor_solve": 0, "resolve": 0, "window_jac": 0, "residual": 0,
            "residual_l1": 0}

_LIB = None
_INFO: dict = {}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dto_window_jac": [_I] * 6 + [_VP] * 7,
    "dto_residual": [_I] * 5 + [_VP] * 8,
    "dto_residual_l1": [_I] * 5 + [_VP] * 9,
    "dto_factor_solve": [_I] * 5 + [ctypes.c_uint] + [_VP] * 18,
    "dto_resolve": [_I] * 5 + [ctypes.c_uint] + [_VP] * 14,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    key = h.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libdto_kernels_{key}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _INFO.update(path=str(so), build_s=time.perf_counter() - t0, log=log)
    _LIB = lib
    return lib


def build_info() -> dict:
    """Path of the loaded library, seconds the build (or load) took, and the
    compiler's output (``-Xptxas -v``: registers, spills) when it built."""
    return dict(_INFO)


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
