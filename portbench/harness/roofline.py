"""The yardstick of a kernel's least time: bytes touched and float32
operations, over the card's published peaks.

Copied from the repository's ``chip_smoke.py`` (``nbytes``, ``time_bound``,
``riccati_ops``, ``horner_ops``) so that a change to the program cannot move
the bound it is measured against. ``nbytes`` works here on metadata taken
when the call was made (:func:`tensor_meta`), so that reading it costs the
traced call no device operation; its count is the original's: the storage the
tensors touch, each element once.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np

# one NVIDIA H100 SXM (data sheet, dense): HBM3 bandwidth and float32 outside
# the tensor cores
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}


class TensorMeta(NamedTuple):
    storage: int  # the storage's address: views of one storage share it
    storage_elems: int
    elem_size: int
    shape: tuple
    stride: tuple
    offset: int
    contiguous: bool

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1


def tensor_meta(t) -> TensorMeta:
    """What :func:`nbytes` needs of a tensor, read without a device operation."""
    st = t.untyped_storage()
    return TensorMeta(st.data_ptr(), st.nbytes() // t.element_size(), t.element_size(),
                      tuple(t.shape), tuple(t.stride()), t.storage_offset(), t.is_contiguous())


def nbytes(metas) -> int:
    """Bytes of storage the tensors touch, each element once: a view that
    overlaps another of the same storage (x and x_next of one knot matrix)
    or repeats its elements (a scalar expanded with stride 0) adds only the
    elements no other view touched."""
    groups: dict = {}
    for m in metas:
        if m.numel:
            groups.setdefault(m.storage, []).append(m)
    total = 0
    for ms in groups.values():
        m0 = ms[0]
        if len(ms) == 1 and m0.contiguous:
            total += m0.numel * m0.elem_size
            continue
        if any(m.elem_size != m0.elem_size for m in ms):
            raise ValueError("views of one storage with different element sizes")
        seen = np.zeros(m0.storage_elems, dtype=bool)
        for m in ms:
            idx = m.offset + sum(np.arange(n, dtype=np.int64).reshape(
                (-1,) + (1,) * (len(m.shape) - 1 - i)) * s
                for i, (n, s) in enumerate(zip(m.shape, m.stride)))
            seen[np.asarray(idx).ravel()] = True
        total += int(seen.sum()) * m0.elem_size
    return total


def time_bound(n_bytes: int, n_ops: int, peaks: dict = PEAKS):
    """Least seconds the card could take to move ``n_bytes`` (each input read
    once, each output written once) and do ``n_ops`` float32 operations, and
    which of the two bounds it."""
    t_bytes, t_ops = n_bytes / peaks["hbm_bytes_per_s"], n_ops / peaks["f32_ops_per_s"]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def riccati_ops(L, N, ns, nv, R, factor: bool) -> int:
    """Float32 operations (a multiply-add counts 2) of K1 (``factor``) or K2:
    per knot and right-hand side the backward w, kff (with its solve) and p,
    and the forward λ, v and next s; K1 adds the factor of every knot."""
    per_rhs = (2 * ns * ns + 2 * ns * nv + 2 * nv * nv + 2 * ns * ns + 2 * nv * ns
               + 2 * ns * ns + 2 * ns * nv + 2 * ns * ns + 2 * nv * ns)
    per_knot = R * per_rhs
    if factor:  # PA, PB, Hvv, Mvs, Cholesky, Kg, AᵀPA + MvsᵀKg
        per_knot += (2 * ns ** 3 + 2 * ns * ns * nv + 2 * nv * nv * ns + 2 * nv * ns * ns
                     + nv ** 3 // 3 + 2 * nv * nv * ns + 2 * ns ** 3 + 2 * ns * ns * nv)
    return L * N * per_knot


def horner_ops(L, K, xd, nd, order, jac: bool, free_time: bool = False) -> int:
    """Float32 operations of K3 (``jac``) or K4 on L lanes × K windows: G and
    A = Δt·G, then per Taylor step y ← x + A·y/k and, for K3, the tangents
    and the matrix E."""
    step = 2 * xd * xd
    if jac:
        step += 4 * nd * xd * xd + 2 * xd ** 3 + (4 * xd * xd if free_time else 0)
    return L * K * (2 * nd * xd * xd + xd * xd + order * step + xd)


def _tensors(args):
    for a in args:
        if isinstance(a, TensorMeta):
            yield a
        elif isinstance(a, tuple):
            yield from _tensors(a)


def _layout_key(metas) -> tuple:
    """The metadata with each storage named by its first appearance: calls
    at the same shapes on other storages share the key."""
    names: dict = {}
    return tuple(m._replace(storage=names.setdefault(m.storage, len(names))) for m in metas)


@lru_cache(maxsize=256)
def _nbytes_of_key(key: tuple) -> int:
    return nbytes(key)


def call_bytes(call) -> int:
    """Bytes a recorded kernel-layer call touches: its tensor arguments
    read once, its results written once."""
    return (_nbytes_of_key(_layout_key(list(_tensors(call.args))))
            + _nbytes_of_key(_layout_key(list(call.outs))))


def layer_share(t, ops_of_call):
    """A layer's share of its roofline in %: the sum over the traced call's
    recorded calls into the layer (the functions the metric's data file
    ``wrap`` lists) of each call's least time, over the device time of the
    kernels whose names match the data file's ``patterns``. Nothing where
    the layer made no call, where a call took the plain PyTorch version
    (its device time is not the kernels'), or where no kernel matched."""
    calls = [c for c in t.kernel_calls if c.fn in t.data["wrap"]]
    if not calls or any(t.counters["PLAIN_CALLS"].get(k, 0) for k in t.data["plain_keys"]):
        return None
    device = t.profile.device_time(t.data["patterns"])
    if device <= 0:
        return None
    least = sum(time_bound(call_bytes(c), ops_of_call(c))[0] for c in calls)
    return 100.0 * least / device
