"""Bilinear window Jacobians and residual chains: CUDA kernels and plain versions.

Counterpart of ``directtrajopt_tpu/ops/expv_kernel.py``. For every window
k of every lane, with ``G = Gd + Σ_m u_m·Gv_m`` and ``A = Δt·G``:

* :func:`window_jac` — ``J = ∂(E·x)/∂(x, u, Δt)`` (columns x, u, Δt), E the
  order-m Taylor action, by tangent recurrences of the Horner chain
  ``y ← x + A·y/k`` (replaces the Pallas ``_kernel``);
* :func:`residual_action` — ``xn − E·x`` (replaces ``_res_kernel``);
* :func:`residual_l1` — ``Σ|xn − E·x|`` per lane over all windows (the
  line-search θ term; ``_res_kernel`` in its L1 form).

Shapes: Gd (L, xd, xd), Gv (L, nd, xd, xd), u (L, K, nd), dt (L, K),
x / xn (L, K, xd), where L counts lanes (problems × line-search trials,
flattened by the caller in place of the JAX package's two-level
``custom_vmap``).

Routing: a CPU tensor takes the plain PyTorch version; a CUDA float32
tensor launches the kernel (``csrc/expv_kernel.cu``) or raises; float64
takes the plain version on either device, as the JAX package sends f64 to
XLA. The plain versions are ports of ``_window_jac_xla`` and ``_res_xla``.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = [
    "window_jac", "window_jac_plain",
    "residual_action", "residual_action_plain",
    "residual_l1", "residual_l1_plain",
    "SUPPORTED_SHAPES",
]

# (x_dim, n_drives) pairs instantiated in csrc/expv_kernel.cu: the bilinear
# benchmark's 4-D state with 2 drives
SUPPORTED_SHAPES = {(4, 2)}


def window_jac_plain(order, free_time, Gd, Gv, u, dt, x):
    """(L, K, xd, n_th) window Jacobians — port of ``_window_jac_xla``."""
    L, K, xd = x.shape
    nd = Gv.shape[1]
    dtype, dev = x.dtype, x.device
    G = Gd[:, None] + torch.einsum("lkm,lmij->lkij", u, Gv)
    A = dt[..., None, None] * G
    eye = torch.eye(xd, dtype=dtype, device=dev).expand(L, K, xd, xd)
    E = eye
    y = x
    yd_u = torch.zeros((L, K, nd, xd), dtype=dtype, device=dev)
    yd_t = torch.zeros((L, K, xd), dtype=dtype, device=dev)
    Ad_u = dt[..., None, None, None] * Gv[:, None]
    for k in range(order, 0, -1):
        # tangents first: they reference the PREVIOUS y (jacfwd order)
        yd_u = (
            torch.einsum("lkmij,lkj->lkmi", Ad_u, y)
            + torch.einsum("lkij,lkmj->lkmi", A, yd_u)
        ) / k
        if free_time:
            yd_t = (
                torch.einsum("lkij,lkj->lki", G, y) + torch.einsum("lkij,lkj->lki", A, yd_t)
            ) / k
        E = eye + (A @ E) / k
        y = x + torch.einsum("lkij,lkj->lki", A, y) / k
    parts = [E, yd_u.transpose(-1, -2)]
    if free_time:
        parts.append(yd_t[..., None])
    return torch.cat(parts, dim=-1)


def residual_action_plain(order, Gd, Gv, u, dt, x, xn):
    """(L, K, xd) residuals ``xn − E·x`` — port of ``_res_xla``."""
    G = Gd[:, None] + torch.einsum("lkm,lmij->lkij", u, Gv)
    A = dt[..., None, None] * G
    y = x
    for k in range(order, 0, -1):
        y = x + torch.einsum("lkij,lkj->lki", A, y) / k
    return xn - y


def residual_l1_plain(order, Gd, Gv, u, dt, x, xn):
    """(L,) ``Σ|xn − E·x|`` over windows and state components."""
    return residual_action_plain(order, Gd, Gv, u, dt, x, xn).abs().sum((-2, -1))


def _kernel_args(Gd, Gv, u, dt, x, xn=None):
    """Validate a CUDA call: float32, contiguous, one device, matching shapes."""
    L, K, xd = x.shape
    nd = Gv.shape[1]
    want = {
        "Gd": (Gd, (L, xd, xd)), "Gv": (Gv, (L, nd, xd, xd)), "u": (u, (L, K, nd)),
        "dt": (dt, (L, K)), "x": (x, (L, K, xd)),
    }
    if xn is not None:
        want["xn"] = (xn, (L, K, xd))
    for name, (t, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the kernel, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (xd, nd) not in SUPPORTED_SHAPES:
        raise NotImplementedError(
            f"no kernel instantiation for x_dim={xd}, n_drives={nd} "
            f"(instantiated: {sorted(SUPPORTED_SHAPES)})"
        )
    return L, K, xd, nd


def _route(x: torch.Tensor) -> bool:
    """True → launch the kernel; False → plain version (CPU or float64)."""
    if x.device.type == "cpu" or x.dtype == torch.float64:
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def window_jac(order: int, free_time: bool, Gd, Gv, u, dt, x):
    """Window Jacobians (L, K, xd, xd + nd [+1]); see module docstring."""
    if not _route(x):
        return window_jac_plain(order, free_time, Gd, Gv, u, dt, x)
    L, K, xd, nd = _kernel_args(Gd, Gv, u, dt, x)
    n_th = xd + nd + (1 if free_time else 0)
    out = torch.empty((L, K, xd, n_th), dtype=torch.float32, device=x.device)
    rc = _build.library().dto_window_jac(
        L, K, xd, nd, int(order), int(bool(free_time)),
        Gd.data_ptr(), Gv.data_ptr(), u.data_ptr(), dt.data_ptr(), x.data_ptr(),
        out.data_ptr(), _build.stream_ptr(x.device),
    )
    _build.check_rc(rc, "window_jac")
    _build.LAUNCHES["window_jac"] += 1
    return out


def residual_action(order: int, Gd, Gv, u, dt, x, xn):
    """Residuals (L, K, xd); see module docstring."""
    if not _route(x):
        return residual_action_plain(order, Gd, Gv, u, dt, x, xn)
    L, K, xd, nd = _kernel_args(Gd, Gv, u, dt, x, xn)
    out = torch.empty((L, K, xd), dtype=torch.float32, device=x.device)
    rc = _build.library().dto_residual(
        L, K, xd, nd, int(order), Gd.data_ptr(), Gv.data_ptr(), u.data_ptr(),
        dt.data_ptr(), x.data_ptr(), xn.data_ptr(), out.data_ptr(),
        _build.stream_ptr(x.device),
    )
    _build.check_rc(rc, "residual_action")
    _build.LAUNCHES["residual"] += 1
    return out


def residual_l1(order: int, Gd, Gv, u, dt, x, xn):
    """Per-lane ``Σ|residual|`` (L,); see module docstring."""
    if not _route(x):
        return residual_l1_plain(order, Gd, Gv, u, dt, x, xn)
    L, K, xd, nd = _kernel_args(Gd, Gv, u, dt, x, xn)
    part = torch.empty((L, K), dtype=torch.float32, device=x.device)
    out = torch.empty((L,), dtype=torch.float32, device=x.device)
    rc = _build.library().dto_residual_l1(
        L, K, xd, nd, int(order), Gd.data_ptr(), Gv.data_ptr(), u.data_ptr(),
        dt.data_ptr(), x.data_ptr(), xn.data_ptr(), part.data_ptr(), out.data_ptr(),
        _build.stream_ptr(x.device),
    )
    _build.check_rc(rc, "residual_l1")
    _build.LAUNCHES["residual_l1"] += 1
    return out
