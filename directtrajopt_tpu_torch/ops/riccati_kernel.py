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

Routing: CPU → plain version; CUDA float32 → the kernel
(``csrc/riccati_kernel.cu``) or raise; float64 → plain version. The plain
versions are ports of ``_factor_solve_xla`` / ``_resolve_xla``: a loop over
knots with batched small matmuls and ``torch.linalg.cholesky_ex``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["factor_solve", "factor_solve_plain", "resolve", "resolve_plain", "MAX_SIZES"]

# kernel compile-time bounds (csrc/riccati_kernel.cu: kNsMax, kNvMax, kRMax)
MAX_SIZES = {"ns": 16, "nv": 8, "R": 8}


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


def _lanes_minor_stage(x: torch.Tensor) -> torch.Tensor:
    """(L, N, r, c) → contiguous (N, r, c, L)."""
    return x.permute(1, 2, 3, 0).contiguous()


def _lanes_minor_rhs(x: torch.Tensor) -> torch.Tensor:
    """(L, R, N, d) → contiguous (N, R, d, L)."""
    return x.permute(2, 1, 3, 0).contiguous()


def _use_kernel(x: torch.Tensor, tensors: dict, sizes: dict) -> bool:
    if x.device.type == "cpu" or x.dtype == torch.float64:
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the kernel, got {t.dtype}")
    for k, v in sizes.items():
        if not 1 <= v <= MAX_SIZES[k]:
            raise NotImplementedError(f"{k}={v} exceeds the kernel's bound {MAX_SIZES[k]}")
    return True


def _check_shapes(pairs: dict) -> None:
    for name, (t, shape) in pairs.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def factor_solve(s0m, Qss, Qsv, Qvv, A, B, qs, qv, b):
    """Fused factor + R-RHS solve; see module docstring."""
    L, N, ns, _ = Qss.shape
    nv = Qvv.shape[-1]
    R = qs.shape[1]
    ins = dict(Qss=Qss, Qsv=Qsv, Qvv=Qvv, A=A, B=B, qs=qs, qv=qv, b=b)
    _check_shapes({
        "Qss": (Qss, (L, N, ns, ns)), "Qsv": (Qsv, (L, N, ns, nv)),
        "Qvv": (Qvv, (L, N, nv, nv)), "A": (A, (L, N, ns, ns)), "B": (B, (L, N, ns, nv)),
        "qs": (qs, (L, R, N, ns)), "qv": (qv, (L, R, N, nv)), "b": (b, (L, R, N, ns)),
    })
    if not _use_kernel(Qss, ins, {"ns": ns, "nv": nv, "R": R}):
        return factor_solve_plain(s0m, Qss, Qsv, Qvv, A, B, qs, qv, b)
    dev = Qss.device
    kw = dict(dtype=torch.float32, device=dev)
    stage = [_lanes_minor_stage(t) for t in (Qss, Qsv, Qvv, A, B)]
    rhs = [_lanes_minor_rhs(t) for t in (qs, qv, b)]
    Nm1 = max(N - 1, 1)
    P_t = torch.empty((N, ns, ns, L), **kw)
    L_t = torch.empty((N, nv, nv, L), **kw)
    Kg_t = torch.empty((N, nv, ns, L), **kw)
    Mvs_t = torch.empty((N, nv, ns, L), **kw)
    L0_t = torch.empty((ns, ns, L), **kw)
    ok_t = torch.empty((L,), **kw)
    dzs_t = torch.empty((N, R, ns, L), **kw)
    dzv_t = torch.empty((N, R, nv, L), **kw)
    lam_t = torch.empty((Nm1, R, ns, L), **kw)
    rc = _build.library().dto_factor_solve(
        L, N, ns, nv, R, _s0_bits(s0m),
        *(t.data_ptr() for t in stage + rhs),
        *(t.data_ptr() for t in (P_t, L_t, Kg_t, Mvs_t, L0_t, ok_t, dzs_t, dzv_t, lam_t)),
        _build.stream_ptr(dev),
    )
    _build.check_rc(rc, "factor_solve")
    _build.LAUNCHES["factor_solve"] += 1
    return (
        P_t.permute(3, 0, 1, 2), L_t.permute(3, 0, 1, 2), Kg_t.permute(3, 0, 1, 2),
        Mvs_t.permute(3, 0, 1, 2), L0_t.permute(2, 0, 1), ok_t > 0.5,
        dzs_t.permute(3, 1, 0, 2), dzv_t.permute(3, 1, 0, 2),
        lam_t.permute(3, 1, 0, 2)[:, :, : N - 1],
    )


def resolve(s0m, P, Lv, Kg, Mvs, L0, A, B, qs, qv, b):
    """Solve new right-hand sides with stored factors; see module docstring."""
    L, N, ns, _ = P.shape
    nv = Lv.shape[-1]
    R = qs.shape[1]
    ins = dict(P=P, Lv=Lv, Kg=Kg, Mvs=Mvs, L0=L0, A=A, B=B, qs=qs, qv=qv, b=b)
    _check_shapes({
        "P": (P, (L, N, ns, ns)), "Lv": (Lv, (L, N, nv, nv)), "Kg": (Kg, (L, N, nv, ns)),
        "Mvs": (Mvs, (L, N, nv, ns)), "L0": (L0, (L, ns, ns)), "A": (A, (L, N, ns, ns)),
        "B": (B, (L, N, ns, nv)), "qs": (qs, (L, R, N, ns)), "qv": (qv, (L, R, N, nv)),
        "b": (b, (L, R, N, ns)),
    })
    if not _use_kernel(P, ins, {"ns": ns, "nv": nv, "R": R}):
        return resolve_plain(s0m, P, Lv, Kg, Mvs, L0, A, B, qs, qv, b)
    dev = P.device
    kw = dict(dtype=torch.float32, device=dev)
    stage = [_lanes_minor_stage(t) for t in (P, Lv, Kg, Mvs)]
    L0_t = L0.permute(1, 2, 0).contiguous()
    ab = [_lanes_minor_stage(t) for t in (A, B)]
    rhs = [_lanes_minor_rhs(t) for t in (qs, qv, b)]
    dzs_t = torch.empty((N, R, ns, L), **kw)
    dzv_t = torch.empty((N, R, nv, L), **kw)
    lam_t = torch.empty((max(N - 1, 1), R, ns, L), **kw)
    rc = _build.library().dto_resolve(
        L, N, ns, nv, R, _s0_bits(s0m),
        *(t.data_ptr() for t in stage + [L0_t] + ab + rhs),
        dzs_t.data_ptr(), dzv_t.data_ptr(), lam_t.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check_rc(rc, "resolve")
    _build.LAUNCHES["resolve"] += 1
    return (dzs_t.permute(3, 1, 0, 2), dzv_t.permute(3, 1, 0, 2),
            lam_t.permute(3, 1, 0, 2)[:, :, : N - 1])
