"""Build and load the port's CUDA kernels.

All sources under ``directtrajopt_tpu_torch/csrc/`` (``*.cu``, which may
include the ``*.cuh`` headers beside them) are compiled by ``nvcc`` (one
compiler per source, all running at once) and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, into ``directtrajopt_tpu_torch/_build/``, and is keyed by a hash
of the sources, headers and flags, so an edited file rebuilds and an
unchanged tree loads the existing library.

Flags: ``sm_90a`` (Hopper), ``-O3``, and *no* fast math — the kernels rely
on correctly rounded division and square root (nvcc's defaults
``-prec-div=true -prec-sqrt=true -ftz=false``).

Every kernel wrapper counts its launches in :data:`LAUNCHES`, so a run can
show that its main path went through the kernels; :data:`INSTANCES` counts
the K1/K2 launches and the size-class K3/K4 launches a second time, by CUDA
kernel, and so overlaps :data:`LAUNCHES` (see there). :func:`route` decides, as
the JAX package's ``pallas_eligible`` and ``window_jac_eligible`` do without
their VMEM terms, whether a call takes the kernel or its plain PyTorch
version; :data:`PLAIN_CALLS` counts the float32 calls on the card that the
shape caps send to the plain version (the counterpart of the JAX package's
XLA route).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils.profiling import span

__all__ = ["LAUNCHES", "PLAIN_CALLS", "INSTANCES", "reset_launches", "count_launch", "route",
           "library", "build_info", "stream_ptr"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

# launches by kernel: K1 and K2 (grouped, column or size-class; by CUDA
# kernel in INSTANCES); K3 and K4 at their exact shapes, and under
# ``*_generic`` at every other shape (the size-class kernels; by class in
# INSTANCES)
LAUNCHES = {"factor_solve": 0, "resolve": 0, "window_jac": 0, "residual": 0,
            "residual_l1": 0, "window_jac_generic": 0, "residual_generic": 0,
            "residual_l1_generic": 0}
# float32 calls on the card that the shape caps sent to the plain version, by wrapper
PLAIN_CALLS = {"factor_solve": 0, "resolve": 0, "window_jac": 0, "residual": 0,
               "residual_l1": 0}
# K1/K2 and size-class K3/K4 launches by CUDA kernel, as -Xptxas -v names
# it, with their template arguments (``factor_solve_grouped<10,3,3>``,
# ``resolve_columns<4,1>``, ``factor_solve_classed<8,4,8>``,
# ``window_jac_classed<8,2>``, ``residual_classed<8,2,1>``); counted beside
# LAUNCHES, by the same launches: LAUNCHES's ``factor_solve`` / ``resolve``
# and ``*_generic`` are the sums of their instances' counts.
INSTANCES: dict = {}

# The Pallas kernels' shape caps (directtrajopt_tpu/ops/riccati_kernel.py
# pallas_eligible, ops/expv_kernel.py window_jac_eligible), without their
# VMEM budgets: K1/K2 at 1 ≤ n_s, n_v ≤ 24 and R ≤ 40; K3/K4 at
# 1 ≤ x_dim ≤ 8 and n_drives ≤ 8.
RICCATI_CAPS = {"ns": 24, "nv": 24, "R": 40}
EXPV_CAPS = {"xd": 8, "nd": 8}

_LIB = None
_INFO: dict = {}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dto_window_jac": [_I] * 6 + [_VP] * 8,
    "dto_residual": [_I] * 7 + [_VP] * 9,
    "dto_factor_solve_grouped": [_I] * 5 + [ctypes.c_uint] + [_VP] * 18,
    "dto_factor_solve_classed": [_I] * 5 + [ctypes.c_uint] + [_I] * 4 + [_VP] * 18,
    "dto_resolve_grouped": [_I] * 5 + [ctypes.c_uint] + [_VP] * 14,
    "dto_resolve_columns": [_I] * 5 + [ctypes.c_uint] + [_VP] * 14,
    "dto_resolve_classed": [_I] * 5 + [ctypes.c_uint] + [_I] * 4 + [_VP] * 14,
    "dto_classed_smem_bytes": [_I] * 3,
}


def reset_launches() -> None:
    """Set every count of :data:`LAUNCHES` and :data:`PLAIN_CALLS` to 0, and
    empty :data:`INSTANCES`."""
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0
    INSTANCES.clear()


def count_launch(key: str, kernel: str) -> None:
    """Count one launch of CUDA kernel ``kernel`` under :data:`LAUNCHES`'s
    ``key`` and :data:`INSTANCES`'s ``kernel``."""
    LAUNCHES[key] += 1
    INSTANCES[kernel] = INSTANCES.get(kernel, 0) + 1


def route(kind: str, device_type: str, dtype, sizes: dict) -> str:
    """"kernel" or "plain" for a call of ``kind`` ("riccati": K1/K2, sizes
    ns, nv, R; "expv": K3/K4, sizes xd, nd) on ``device_type`` in ``dtype``:
    the CPU and float64 take the plain version; float32 on the card takes
    the kernel within the shape caps (:data:`RICCATI_CAPS`,
    :data:`EXPV_CAPS`) and the plain version beyond them."""
    import torch

    if kind == "riccati":
        within = (1 <= sizes["ns"] <= RICCATI_CAPS["ns"] and 1 <= sizes["nv"] <= RICCATI_CAPS["nv"]
                  and 1 <= sizes["R"] <= RICCATI_CAPS["R"])
    elif kind == "expv":
        within = 1 <= sizes["xd"] <= EXPV_CAPS["xd"] and 0 <= sizes["nd"] <= EXPV_CAPS["nd"]
    else:
        raise ValueError(f"unknown kernel kind {kind!r}")
    if device_type == "cpu" or dtype == torch.float64:
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    if dtype != torch.float32:
        raise TypeError(f"the kernels take float32 or float64, got {dtype}")
    return "kernel" if within else "plain"


def count_plain(x, key: str) -> None:
    """Count a plain-version call of wrapper ``key`` where it ran in float32
    on the card (the shape caps sent it there)."""
    import torch

    if x.device.type == "cuda" and x.dtype == torch.float32:
        PLAIN_CALLS[key] += 1


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


def _headers() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cuh"))


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with span("build.library"):
        return _load()


def _load() -> ctypes.CDLL:
    """Hash the sources, then load the library the hash names, or build it."""
    global _LIB
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for s in srcs + _headers():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    key = h.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libdto_kernels_{key}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        # one compiler per source, all started at once, then one link
        tmp = BUILD_DIR / f".{so.name}.{os.getpid()}"
        objs = [f"{tmp}.{s.stem}.o" for s in srcs]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o, str(s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        log = "".join(p.communicate()[0] for p in procs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        proc = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", f"{tmp}.so", *objs],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(f"{tmp}.so", so)
        for o in objs:
            os.remove(o)
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
    compilers' output (``-Xptxas -v``: registers, spills) when they built."""
    return dict(_INFO)


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a
    ``torch.device`` or an index), which every kernel launches on."""
    import torch

    index = device if isinstance(device, int) else device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
