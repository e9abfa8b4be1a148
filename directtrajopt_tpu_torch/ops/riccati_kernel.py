"""Fused Riccati KKT factor + solve: CUDA kernels and plain versions.

Counterpart of ``directtrajopt_tpu/ops/riccati_kernel.py``.

* :func:`factor_solve` — per lane, the backward Riccati sweep over the N
  stages fused with R right-hand-side recursions, the masked Cholesky of
  P0 over the free initial states, and the forward sweep for (dzs, dzv, λ).
  Replaces the Pallas ``_fused_kernel``.
* :func:`resolve` — the same solve for new right-hand sides against stored
  factors (P, Lv, Kg, Mvs, L0). Replaces the Pallas ``_resolve_kernel``.

Shapes (L lanes): Qss (L,N,ns,ns), Qsv (L,N,ns,nv), Qvv (L,N,nv,nv),
A (L,N,ns,ns), B (L,N,ns,nv) — stage N−1 rows of A/B are zero padding;
qs / b (L,R,N,ns), qv (L,R,N,nv); ``s0m`` a static (ns,) 0/1 mask of the
free initial-state coordinates. Outputs P (L,N,ns,ns), Lv (L,N,nv,nv),
Kg / Mvs (L,N,nv,ns), L0 (L,ns,ns), ok (L,) bool, dzs (L,R,N,ns),
dzv (L,R,N,nv), λ (L,R,N−1,ns).

``ok`` is the inertia certificate: false where any pivot of a stage's Hvv or
of the masked P0 is not positive (or non-finite); the identity is then
substituted for that factor, as the JAX package's XLA scan does.

Routing (``_build.route``, the JAX package's ``pallas_eligible`` without its
VMEM term): CPU → plain version; float64 → plain version; CUDA float32 → the
kernel (``csrc/riccati_kernel.cu``) within the Pallas kernels' caps,
1 ≤ n_s, n_v ≤ 24 and R ≤ 40, and the plain version beyond them (counted in
``_build.PLAIN_CALLS``). K2 takes up to 40 right-hand sides in one launch;
K1 up to 8, and 8 < R ≤ 40 as K1 on the first 8 columns and K2 on the rest
(:func:`split_factor_solve`, two launches). Each takes its shape's design
(:func:`design`, a pure function of the kind and shape): a shape in
:data:`GROUPED_SHAPES` (K1) or :data:`RESOLVE_GROUPED_SHAPES` (K2) runs
``factor_solve_grouped`` / ``resolve_grouped`` (a thread group per lane,
reading and writing the lane-major tensors above as they are); a K2 at
(n_s, n_v) in :data:`RESOLVE_COLUMN_SHAPES` with any other R runs
``resolve_columns`` (a thread per lane and right-hand side, the same
tensors, no copy); every other shape the size-class kernel
``factor_solve_classed`` / ``resolve_classed`` of the least class in
:data:`SIZE_CLASSES` that holds it (:func:`size_class`): the grouped
design at run-time sizes, on the same tensors, no copy
(:func:`factor_solve_classed`, :func:`resolve_classed`). Each launch also
counts in ``_build.INSTANCES`` under its CUDA kernel's name
(``factor_solve_grouped<10,3,3>``, ``resolve_columns<4,1>``,
``factor_solve_classed<8,4,8>``, …). The plain versions are
ports of ``_factor_solve_xla`` / ``_resolve_xla``: a loop over knots with
batched small matmuls and ``torch.linalg.cholesky_ex``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["factor_solve", "factor_solve_plain", "factor_solve_classed", "resolve",
           "resolve_plain", "resolve_classed", "split_factor_solve", "design", "size_class",
           "classed_smem_bytes", "MAX_SIZES", "RESOLVE_MAX_SIZES", "SIZE_CLASSES", "GROUPED_SHAPES",
           "RESOLVE_GROUPED_SHAPES", "RESOLVE_COLUMN_SHAPES"]

# K1 takes R ≤ 8 right-hand sides in one launch (csrc/riccati_classed.cuh:
# the classes' RC), and 8 < R ≤ 40 through :func:`split_factor_solve`: its first
# 8 columns, then the rest through K2 against the factors K1 returned.
MAX_SIZES = {"R": 8}
# K2 takes up to the Pallas resolve's 40 right-hand sides in one launch
RESOLVE_MAX_SIZES = {"R": 40}
# (NSC, NVC, RC) size classes of factor_solve_classed / resolve_classed, in
# order of size: a shape with no exact instance takes the first that holds
# its (n_s, n_v) (:func:`size_class`); K2 sweeps R' ≤ 40 in tiles of RC
SIZE_CLASSES = ((4, 4, 8), (8, 4, 8), (16, 4, 8), (8, 8, 8), (16, 8, 8), (24, 24, 8))
# the size-class kernels' n_v class bound up to which Hvv's factor stays in
# registers (csrc/riccati_classed.cuh kRegNv); beyond, in shared memory
_REG_NV = 4
# (n_s, n_v, R) instantiations of K1's factor_solve_grouped: path 1's bilinear
# gate problem, path 2's state-constrained family, path 3's global-phase
# family (R = 4 border + 2 arrowhead columns + the main system), the
# scaling family at state_dim 8 and 16 (path 7) and the cartpole family
# (path 5)
GROUPED_SHAPES = frozenset({(8, 3, 3), (2, 1, 3), (2, 1, 7), (10, 3, 3), (18, 3, 3),
                            (4, 1, 1)})
# (n_s, n_v, R') instantiations of K2's resolve_grouped: the fused SOC +
# restoration resolve of the same paths
RESOLVE_GROUPED_SHAPES = frozenset({(8, 3, 2), (2, 1, 2), (10, 3, 2), (18, 3, 2), (4, 1, 2)})
# (n_s, n_v) instantiations of K2's resolve_columns, for every R' ≤ 40 not in
# RESOLVE_GROUPED_SHAPES: the cartpole family's L-BFGS SMW columns (path 5b,
# R' = 2m = 40)
RESOLVE_COLUMN_SHAPES = frozenset({(4, 1)})


def design(kind: str, ns: int, nv: int, R: int) -> str:
    """The kernel design a float32 call on the card takes within the caps:
    for ``kind`` "factor_solve" (K1) "grouped", "split" (R > 8: K1 on 8
    columns, K2 on the rest) or "classed"; for "resolve" (K2) "grouped",
    "columns" or "classed"."""
    if kind == "factor_solve":
        if R > MAX_SIZES["R"]:
            return "split"
        if (ns, nv, R) in GROUPED_SHAPES:
            return "grouped"
    elif kind == "resolve":
        if (ns, nv, R) in RESOLVE_GROUPED_SHAPES:
            return "grouped"
        if (ns, nv) in RESOLVE_COLUMN_SHAPES:
            return "columns"
    else:
        raise ValueError(f"unknown kernel {kind!r}")
    return "classed"


def size_class(kind: str, ns: int, nv: int, R: int) -> tuple:
    """The (NSC, NVC, RC) class of :data:`SIZE_CLASSES` whose kernel a
    ``kind`` call ("factor_solve" or "resolve") at (n_s, n_v, R) takes: the
    first that holds (n_s, n_v). ValueError beyond the caps, or for K1
    beyond R = 8 (split first)."""
    if kind not in ("factor_solve", "resolve"):
        raise ValueError(f"unknown kernel {kind!r}")
    caps = _build.RICCATI_CAPS
    r_max = (MAX_SIZES if kind == "factor_solve" else RESOLVE_MAX_SIZES)["R"]
    if not (1 <= ns <= caps["ns"] and 1 <= nv <= caps["nv"] and 1 <= R <= r_max):
        raise ValueError(f"{kind} at (n_s, n_v, R) = {(ns, nv, R)} has no size class")
    return next(c for c in SIZE_CLASSES if ns <= c[0] and nv <= c[1])


def _align4(n: int) -> int:
    return (n + 3) & ~3


def _pow2_at_least(n: int) -> int:
    return 1 if n <= 1 else 2 * _pow2_at_least((n + 1) // 2)


def classed_smem_bytes(kind: str, ns: int, nv: int, R: int) -> int:
    """Shared memory a block of the size-class kernel takes for a ``kind``
    call at (n_s, n_v, R): ``ClassLayout``'s lane stride at the class's
    sizes times its lanes a block (csrc/riccati_classed.cuh; the C entry
    refuses a call whose bytes are not its own)."""
    S, V, RC = size_class(kind, ns, nv, R)
    G = _pow2_at_least(max(S, V))

    def blocks(sizes):
        """Floats of consecutive blocks, each starting on 16 bytes."""
        end = 0
        for n in sizes:
            end = _align4(end + n)
        return end

    # the backward buffer (Qss, Qsv, Qvv, A, B, qs, qv, b), the forward one
    # (P, Kg, A, B, b, p, kff), kStages = 2 of the larger; then the scratch
    # (PA, PB, W, Kg, Pn, S and, beyond kRegNv, H, M, F)
    bwd = blocks((S * S, S * V, V * V, S * S, S * V, RC * S, RC * V, RC * S))
    fwd = blocks((S * S, V * S, S * S, S * V, RC * S, RC * S, RC * V))
    sv = 1 if V > _REG_NV else 0
    end = 2 * max(bwd, fwd) + blocks((S * S, S * V, RC * S, V * S, S * S, RC * S, sv * V * V,
                                      sv * V * S, sv * RC * V))
    pad = max(G, 4)
    stride = end + (pad - end % 32 + 32) % 32
    return (64 // G) * stride * 4


def _chol_or_identity(H: torch.Tensor):
    """Batched Cholesky with the identity substituted where it fails."""
    Lc, info = torch.linalg.cholesky_ex(H)
    ok = (info == 0) & torch.isfinite(Lc).all(-1).all(-1)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return torch.where(ok[:, None, None], Lc, eye), ok


def _cho_solve_rows(Lf: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Rows of ``rhs`` (L, R, n) solved against ``Lf Lfᵀ`` (L, n, n)."""
    return torch.cholesky_solve(rhs.transpose(-1, -2), Lf).transpose(-1, -2)


def _forward(s0m, L0, p0, P_all, Kg_all, kff_all, p_all, A, B, b):
    """Initial-state solve and forward sweep shared by both plain versions."""
    N = A.shape[1]
    s0 = torch.as_tensor(np.asarray(s0m, dtype=np.float64), dtype=A.dtype, device=A.device)
    s = -_cho_solve_rows(L0, p0 * s0) * s0
    s_all, v_all = [], []
    for k in range(N):
        v = s @ Kg_all[:, k].transpose(-1, -2) + kff_all[k]
        s_all.append(s)
        v_all.append(v)
        s = s @ A[:, k].transpose(-1, -2) + v @ B[:, k].transpose(-1, -2) + b[:, :, k]
    dzs = torch.stack(s_all, dim=2)
    dzv = torch.stack(v_all, dim=2)
    p_stack = torch.stack(p_all, dim=2)
    lam = -(torch.einsum("lkij,lrkj->lrki", P_all[:, 1:], dzs[:, :, 1:]) + p_stack[:, :, 1:])
    return dzs, dzv, lam


def factor_solve_plain(s0m, Qss, Qsv, Qvv, A, B, qs, qv, b):
    """Port of ``_factor_solve_xla``, batched over lanes."""
    L, N, ns, _ = Qss.shape
    R = qs.shape[1]
    dtype, dev = Qss.dtype, Qss.device
    P = torch.zeros((L, ns, ns), dtype=dtype, device=dev)
    p = torch.zeros((L, R, ns), dtype=dtype, device=dev)
    ok = torch.ones((L,), dtype=torch.bool, device=dev)
    P_all, Lv_all, Kg_all, Mvs_all = [None] * N, [None] * N, [None] * N, [None] * N
    kff_all, p_all = [None] * N, [None] * N
    for k in reversed(range(N)):
        Ab, Bb = A[:, k], B[:, k]
        PB = P @ Bb
        PA = P @ Ab
        Hvv = Qvv[:, k] + Bb.transpose(-1, -2) @ PB
        Lv, okv = _chol_or_identity(Hvv)
        Mvs = Qsv[:, k].transpose(-1, -2) + Bb.transpose(-1, -2) @ PA
        Kg = -torch.cholesky_solve(Mvs, Lv)
        P_new = Qss[:, k] + Ab.transpose(-1, -2) @ PA + Mvs.transpose(-1, -2) @ Kg
        P_new = 0.5 * (P_new + P_new.transpose(-1, -2))
        # RHS backward recursion, fused with the factor at the same stage
        w = b[:, :, k] @ P.transpose(-1, -2) + p
        mv = qv[:, :, k] + w @ Bb
        kff = -_cho_solve_rows(Lv, mv)
        p_new = qs[:, :, k] + w @ Ab + kff @ Mvs
        P_all[k], Lv_all[k], Kg_all[k], Mvs_all[k] = P_new, Lv, Kg, Mvs
        kff_all[k], p_all[k] = kff, p_new
        P, p, ok = P_new, p_new, ok & okv
    s0 = torch.as_tensor(np.asarray(s0m, dtype=np.float64), dtype=dtype, device=dev)
    P0m = P * s0[:, None] * s0[None, :] + torch.diag(1.0 - s0)
    L0, ok0 = _chol_or_identity(P0m)
    ok = ok & ok0
    P_all = torch.stack(P_all, dim=1)
    Kg_all = torch.stack(Kg_all, dim=1)
    dzs, dzv, lam = _forward(s0m, L0, p, P_all, Kg_all, kff_all, p_all, A, B, b)
    return (P_all, torch.stack(Lv_all, dim=1), Kg_all, torch.stack(Mvs_all, dim=1),
            L0, ok, dzs, dzv, lam)


def resolve_plain(s0m, P, Lv, Kg, Mvs, L0, A, B, qs, qv, b):
    """Port of ``_resolve_xla``, batched over lanes."""
    L, N, ns, _ = P.shape
    R = qs.shape[1]
    p = torch.zeros((L, R, ns), dtype=P.dtype, device=P.device)
    kff_all, p_all = [None] * N, [None] * N
    for k in reversed(range(N)):
        w = p if k == N - 1 else b[:, :, k] @ P[:, k + 1].transpose(-1, -2) + p
        mv = qv[:, :, k] + w @ B[:, k]
        kff = -_cho_solve_rows(Lv[:, k], mv)
        p = qs[:, :, k] + w @ A[:, k] + kff @ Mvs[:, k]
        kff_all[k], p_all[k] = kff, p
    return _forward(s0m, L0, p, P, Kg, kff_all, p_all, A, B, b)


def _s0_bits(s0m) -> int:
    return sum(1 << i for i, v in enumerate(np.asarray(s0m)) if v)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned, as the lane-major kernels' copies
    need; a fresh contiguous tensor is returned as it is."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_lane_major(entry, key, kernel, s0m, ins, outs, L, N, ns, nv, R, extra=()):
    """Launch a lane-major kernel (C ``entry``, counted as CUDA ``kernel``)
    on the inputs as they lie, writing the contiguous ``outs``; ``extra``:
    the entry's arguments after the initial-state mask."""
    dev = ins[0].device
    ins = [_aligned(t) for t in ins]
    rc = getattr(_build.library(), entry)(
        L, N, ns, nv, R, _s0_bits(s0m), *extra,
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        _build.stream_ptr(dev),
    )
    _build.check_rc(rc, key)
    _build.count_launch(key, kernel)
    return outs


def _classed_args(kind, ns, nv, R):
    """The classed C entry's class and shared-memory arguments, and the
    CUDA kernel's name."""
    cls = size_class(kind, ns, nv, R)
    name = f"{kind}_classed<{cls[0]},{cls[1]},{cls[2]}>"
    return (*cls, classed_smem_bytes(kind, ns, nv, R)), name


def _factor_solve_lane_major(which, s0m, ins, L, N, ns, nv, R):
    """Launch ``factor_solve_grouped`` (``which`` "grouped") or
    ``factor_solve_classed`` ("classed") on lane-major inputs; contiguous
    outputs."""
    kw = dict(dtype=torch.float32, device=ins[0].device)
    outs = (
        torch.empty((L, N, ns, ns), **kw), torch.empty((L, N, nv, nv), **kw),
        torch.empty((L, N, nv, ns), **kw), torch.empty((L, N, nv, ns), **kw),
        torch.empty((L, ns, ns), **kw), torch.empty((L,), **kw),
        torch.empty((L, R, N, ns), **kw), torch.empty((L, R, N, nv), **kw),
        torch.empty((L, R, N - 1, ns), **kw),
    )
    if which == "grouped":
        extra, kernel = (), f"factor_solve_grouped<{ns},{nv},{R}>"
    else:
        extra, kernel = _classed_args("factor_solve", ns, nv, R)
    P, Lv, Kg, Mvs, L0, ok, dzs, dzv, lam = _launch_lane_major(
        f"dto_factor_solve_{which}", "factor_solve", kernel, s0m, ins, outs, L, N, ns, nv, R,
        extra)
    return P, Lv, Kg, Mvs, L0, ok > 0.5, dzs, dzv, lam


def _resolve_lane_major(which, s0m, ins, L, N, ns, nv, R):
    """Launch ``resolve_grouped`` (``which`` "grouped"), ``resolve_columns``
    ("columns") or ``resolve_classed`` ("classed") on lane-major inputs;
    contiguous outputs."""
    kw = dict(dtype=torch.float32, device=ins[0].device)
    outs = (torch.empty((L, R, N, ns), **kw), torch.empty((L, R, N, nv), **kw),
            torch.empty((L, R, N - 1, ns), **kw))
    extra = ()
    if which == "grouped":
        kernel = f"resolve_grouped<{ns},{nv},{R}>"
    elif which == "columns":
        kernel = f"resolve_columns<{ns},{nv}>"
    else:
        extra, kernel = _classed_args("resolve", ns, nv, R)
    return _launch_lane_major(f"dto_resolve_{which}", "resolve", kernel, s0m, ins, outs,
                              L, N, ns, nv, R, extra)


def split_factor_solve(factor, resolve_fn, s0m, Qss, Qsv, Qvv, A, B, qs, qv, b):
    """``factor_solve`` for more right-hand sides than K1 takes: the first
    ``MAX_SIZES["R"]`` columns through ``factor`` (K1), the others through
    ``resolve_fn`` (K2) against the factors it returned; the columns'
    solutions concatenated in their order."""
    head = MAX_SIZES["R"]
    sl = slice(0, head)
    out = factor(s0m, Qss, Qsv, Qvv, A, B, qs[:, sl], qv[:, sl], b[:, sl])
    tl = slice(head, None)
    tail = resolve_fn(s0m, *out[:5], A, B, qs[:, tl], qv[:, tl], b[:, tl])
    return (*out[:6], *(torch.cat([h, t], dim=1) for h, t in zip(out[6:], tail)))


def _use_kernel(key: str, x: torch.Tensor, tensors: dict, sizes: dict) -> bool:
    """Whether wrapper ``key``'s call takes the kernel (``_build.route``);
    a float32 call on the card beyond the caps counts in ``PLAIN_CALLS``."""
    if _build.route("riccati", x.device.type, x.dtype, sizes) == "plain":
        _build.count_plain(x, key)
        return False
    _check_kernel_inputs(x, tensors)
    return True


def _check_kernel_inputs(x: torch.Tensor, tensors: dict) -> None:
    dev = x.get_device()
    for name, t in tensors.items():
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the kernel, got {t.dtype}")


def _check_shapes(pairs: dict) -> None:
    for name, (t, shape) in pairs.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def _factor_ins(Qss, Qsv, Qvv, A, B, qs, qv, b):
    """K1's inputs by name and (L, N, n_s, n_v, R), shapes checked."""
    L, N, ns, _ = Qss.shape
    nv = Qvv.shape[-1]
    R = qs.shape[1]
    _check_shapes({
        "Qss": (Qss, (L, N, ns, ns)), "Qsv": (Qsv, (L, N, ns, nv)),
        "Qvv": (Qvv, (L, N, nv, nv)), "A": (A, (L, N, ns, ns)), "B": (B, (L, N, ns, nv)),
        "qs": (qs, (L, R, N, ns)), "qv": (qv, (L, R, N, nv)), "b": (b, (L, R, N, ns)),
    })
    return dict(Qss=Qss, Qsv=Qsv, Qvv=Qvv, A=A, B=B, qs=qs, qv=qv, b=b), (L, N, ns, nv, R)


def _resolve_ins(P, Lv, Kg, Mvs, L0, A, B, qs, qv, b):
    """K2's inputs by name and (L, N, n_s, n_v, R), shapes checked."""
    L, N, ns, _ = P.shape
    nv = Lv.shape[-1]
    R = qs.shape[1]
    _check_shapes({
        "P": (P, (L, N, ns, ns)), "Lv": (Lv, (L, N, nv, nv)), "Kg": (Kg, (L, N, nv, ns)),
        "Mvs": (Mvs, (L, N, nv, ns)), "L0": (L0, (L, ns, ns)), "A": (A, (L, N, ns, ns)),
        "B": (B, (L, N, ns, nv)), "qs": (qs, (L, R, N, ns)), "qv": (qv, (L, R, N, nv)),
        "b": (b, (L, R, N, ns)),
    })
    return dict(P=P, Lv=Lv, Kg=Kg, Mvs=Mvs, L0=L0, A=A, B=B, qs=qs, qv=qv, b=b), (L, N, ns, nv, R)


def factor_solve(s0m, Qss, Qsv, Qvv, A, B, qs, qv, b):
    """Fused factor + R-RHS solve; see module docstring."""
    ins, (L, N, ns, nv, R) = _factor_ins(Qss, Qsv, Qvv, A, B, qs, qv, b)
    if not _use_kernel("factor_solve", Qss, ins, {"ns": ns, "nv": nv, "R": R}):
        return factor_solve_plain(s0m, Qss, Qsv, Qvv, A, B, qs, qv, b)
    which = design("factor_solve", ns, nv, R)
    if which == "split":
        return split_factor_solve(factor_solve, resolve, s0m, Qss, Qsv, Qvv, A, B, qs, qv, b)
    return _factor_solve_lane_major(which, s0m, list(ins.values()), L, N, ns, nv, R)


def factor_solve_classed(s0m, Qss, Qsv, Qvv, A, B, qs, qv, b):
    """K1's size-class kernel on float32 CUDA inputs at any (n_s, n_v) within
    the caps and R ≤ 8, exact shapes included: :func:`factor_solve` takes it
    wherever :func:`design` says "classed"; called directly it times the
    classed kernel beside an exact instance. On the CPU, the plain version."""
    ins, (L, N, ns, nv, R) = _factor_ins(Qss, Qsv, Qvv, A, B, qs, qv, b)
    if Qss.device.type == "cpu":
        return factor_solve_plain(s0m, Qss, Qsv, Qvv, A, B, qs, qv, b)
    _check_kernel_inputs(Qss, ins)
    return _factor_solve_lane_major("classed", s0m, list(ins.values()), L, N, ns, nv, R)


def resolve(s0m, P, Lv, Kg, Mvs, L0, A, B, qs, qv, b):
    """Solve new right-hand sides with stored factors; see module docstring."""
    ins, (L, N, ns, nv, R) = _resolve_ins(P, Lv, Kg, Mvs, L0, A, B, qs, qv, b)
    if not _use_kernel("resolve", P, ins, {"ns": ns, "nv": nv, "R": R}):
        return resolve_plain(s0m, P, Lv, Kg, Mvs, L0, A, B, qs, qv, b)
    which = design("resolve", ns, nv, R)
    return _resolve_lane_major(which, s0m, list(ins.values()), L, N, ns, nv, R)


def resolve_classed(s0m, P, Lv, Kg, Mvs, L0, A, B, qs, qv, b):
    """K2's size-class kernel (tiles of 8 right-hand sides, R ≤ 40) on
    float32 CUDA inputs at any shape within the caps; as
    :func:`factor_solve_classed`."""
    ins, (L, N, ns, nv, R) = _resolve_ins(P, Lv, Kg, Mvs, L0, A, B, qs, qv, b)
    if P.device.type == "cpu":
        return resolve_plain(s0m, P, Lv, Kg, Mvs, L0, A, B, qs, qv, b)
    _check_kernel_inputs(P, ins)
    return _resolve_lane_major("classed", s0m, list(ins.values()), L, N, ns, nv, R)
