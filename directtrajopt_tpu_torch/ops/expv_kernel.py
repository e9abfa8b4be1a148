"""Bilinear window Jacobians and residual chains: CUDA kernels and plain versions.

Counterpart of ``directtrajopt_tpu/ops/expv_kernel.py``. For every window
k of every lane, with ``G = Gd + Σ_m u_m·Gv_m`` and ``A = Δt·G``:

* :func:`window_jac` — ``J = ∂(E·x)/∂(x, u, Δt)`` (columns x, u, Δt), E the
  order-m Taylor action, by tangent recurrences of the Horner chain
  ``y ← x + A·y/k`` (replaces the Pallas ``_kernel``);
* :func:`window_jac_zk` — the residual's Jacobian ``−J`` in the knot's
  width d, J's columns at the offsets of x, u and Δt in the knot and zeros
  elsewhere (the integrator's ``jacobians_zk_stacked``; the same kernel);
* :func:`residual_action` — ``xn − E·x`` (replaces ``_res_kernel``);
* :func:`residual_l1` — ``Σ|xn − E·x|`` per instance over all windows (the
  line-search θ term; ``_res_kernel`` in its L1 form).

Shapes of :func:`window_jac`, the JAX package's interface: Gd (L, xd, xd),
Gv (L, nd, xd, xd), u (L, K, nd), dt (L, K), x (L, K, xd), where L counts
lanes; out (L, K, xd, xd + nd [+1]).

Shapes of :func:`window_jac_zk` and the residual chain: P problems × T
trial slots (T = 1 for a call with no trial axis; the line search's trial
grid as the JAX package's two-level ``custom_vmap`` holds it). Gd
(P, xd, xd) and Gv (P, nd, xd, xd) once per problem, any strides; u
(P, T, K, nd), dt (P, T, K), x and xn (P, T, K, xd) any strided views with a
unit stride on the last axis (the kernels read the knot matrix in place; a
fixed Δt is a scalar expanded with stride 0). Out: (P, T, K, xd, d) for
:func:`window_jac_zk`; (P, T, K, xd), or (P, T) for the L1 form, for the
residual chain.

Routing (``_build.route``, the JAX package's ``window_jac_eligible``
without its VMEM term): a CPU tensor takes the plain PyTorch version;
float64 takes the plain version on either device, as the JAX package sends
f64 to XLA; a CUDA float32 tensor launches the kernel
(``csrc/expv_kernel.cu``) within the Pallas kernels' caps, 1 ≤ x_dim ≤ 8
and n_drives ≤ 8, and takes the plain version beyond them (counted in
``_build.PLAIN_CALLS``). Within the caps, a shape in
:data:`SUPPORTED_SHAPES` runs its exact instantiation and any other the
size-class kernels (``csrc/expv_classed.cu``: a group of threads a window,
registers sized by the first class of :data:`SIZE_CLASSES` that holds the
shape, :func:`size_class`), counted under ``window_jac_generic``,
``residual_generic`` and ``residual_l1_generic`` and, by class, in
``_build.INSTANCES`` (``window_jac_classed<8,2>``,
``residual_classed<8,2,1>`` for the L1 form). The plain versions are ports
of ``_window_jac_xla`` and ``_res_xla`` and take the same arguments as the
wrappers.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "window_jac", "window_jac_plain", "window_jac_zk", "window_jac_zk_plain",
    "residual_action", "residual_action_plain",
    "residual_l1", "residual_l1_plain",
    "SUPPORTED_SHAPES", "SIZE_CLASSES", "design", "size_class",
]

# (x_dim, n_drives) pairs with an exact instantiation in csrc/expv_kernel.cu:
# the bilinear benchmark's 4-D state with 2 drives, and the
# state-constrained family's 2-D state with 1 drive; the size-class kernels
# take the rest of the caps
SUPPORTED_SHAPES = {(4, 2), (2, 1)}
# (x_dim, n_drives) classes of the size-class kernels (csrc/expv_classed.cu),
# in the order the C entries try them: a shape takes the first that holds
# it, its kernel a group of pow2(XC) threads a window with registers for XC
# states and NDC drives. (6, 2) holds a qutrit's state as a real vector,
# (8, 2) the scaling family's state_dim 8 (path 7c), without eight drives'
# tangents.
SIZE_CLASSES = ((2, 2), (4, 2), (6, 2), (8, 2), (4, 8), (8, 8))
# the residual kernel's 19 element strides go in one array (one argument for
# all of them, which halves the cost of the ctypes call); the window
# Jacobian's 16 strides go with its column map (d, o_x, o_u, o_t)
_Strides19 = ctypes.c_longlong * 19
_Strides20 = ctypes.c_longlong * 20


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
    """(P, T, K, xd) residuals ``xn − E·x`` — port of ``_res_xla``."""
    G = Gd[:, None, None] + torch.einsum("ptkm,pmij->ptkij", u, Gv)
    A = dt[..., None, None] * G
    y = x
    for k in range(order, 0, -1):
        y = x + torch.einsum("ptkij,ptkj->ptki", A, y) / k
    return xn - y


def residual_l1_plain(order, Gd, Gv, u, dt, x, xn):
    """(P, T) ``Σ|xn − E·x|`` over windows and state components."""
    return residual_action_plain(order, Gd, Gv, u, dt, x, xn).abs().sum((-2, -1))


def _route(key: str, x: torch.Tensor, Gv: torch.Tensor) -> bool:
    """True → launch wrapper ``key``'s kernel; False → its plain version
    (``_build.route``; a float32 call on the card beyond the caps counts in
    ``PLAIN_CALLS``)."""
    sizes = {"xd": x.shape[-1], "nd": Gv.shape[1]}
    if _build.route("expv", x.device.type, x.dtype, sizes) == "plain":
        _build.count_plain(x, key)
        return False
    return True


def _unit_last(*ts) -> bool:
    """Unit stride on the last axis, as the kernels read it (any stride where
    that axis holds one element or none)."""
    return all(t.shape[-1] <= 1 or t.stride(-1) == 1 for t in ts)


def design(xd: int, nd: int) -> str:
    """The kernel a float32 call on the card within the caps takes:
    "exact" (its own instantiation) or "classed" (a size-class kernel)."""
    return "exact" if (xd, nd) in SUPPORTED_SHAPES else "classed"


def size_class(xd: int, nd: int) -> tuple:
    """The (XC, NDC) class of :data:`SIZE_CLASSES` whose kernels a call at
    (x_dim, n_drives) without an exact instantiation takes: the first that
    holds it, as the C entries choose. ValueError beyond the caps."""
    if not (1 <= xd <= _build.EXPV_CAPS["xd"] and 0 <= nd <= _build.EXPV_CAPS["nd"]):
        raise ValueError(f"(x_dim, n_drives) = {(xd, nd)} has no size class")
    return next(c for c in SIZE_CLASSES if xd <= c[0] and nd <= c[1])


def _launch_key(key: str, xd: int, nd: int) -> str:
    """The launch-count key of the exact (``key``) or size-class
    (``{key}_generic``) kernel."""
    return key if design(xd, nd) == "exact" else f"{key}_generic"


def _count(key: str, xd: int, nd: int) -> None:
    """Count a launch of wrapper ``key``'s kernel under its launch key and,
    for a size-class kernel, under its name in ``_build.INSTANCES``."""
    if design(xd, nd) == "exact":
        _build.LAUNCHES[key] += 1
        return
    xc, ndc = size_class(xd, nd)
    kernel = (f"window_jac_classed<{xc},{ndc}>" if key == "window_jac" else
              f"residual_classed<{xc},{ndc},{int(key == 'residual_l1')}>")
    _build.count_launch(_launch_key(key, xd, nd), kernel)


def window_jac_zk_plain(order, Gd, Gv, u, dt, x, cols, d):
    """(P, T, K, xd, d): −:func:`window_jac_plain` on the (P·T) lanes, its
    columns placed at ``cols``, zeros elsewhere (see :func:`window_jac_zk`)."""
    P, T, K, xd = x.shape
    o_x, o_u, o_t = cols
    nd = Gv.shape[1]

    def lanes(t):
        return t.reshape((P * T,) + t.shape[2:]).contiguous()

    def per_lane(g):
        return g[:, None].expand((P, T) + g.shape[1:]).reshape((P * T,) + g.shape[1:])

    J = window_jac_plain(order, o_t is not None, per_lane(Gd), per_lane(Gv), lanes(u), lanes(dt),
                         lanes(x))
    idx = list(range(o_x, o_x + xd)) + list(range(o_u, o_u + nd))
    if o_t is not None:
        idx.append(o_t)
    out = torch.zeros((P * T, K, xd, d), dtype=J.dtype, device=J.device)
    out[..., idx] = -J
    return out.reshape(P, T, K, xd, d)


def window_jac(order: int, free_time: bool, Gd, Gv, u, dt, x):
    """Window Jacobians (L, K, xd, xd + nd [+1]); see module docstring. On
    the card: :func:`window_jac_zk` with J's own columns, negated back."""
    if not _route("window_jac", x, Gv):
        return window_jac_plain(order, free_time, Gd, Gv, u, dt, x)
    xd, nd = x.shape[-1], Gv.shape[1]
    cols = (0, xd, xd + nd if free_time else None)
    n_th = xd + nd + (1 if free_time else 0)
    return -window_jac_zk(order, Gd, Gv, u[:, None], dt[:, None], x[:, None], cols, n_th)[:, 0]


def window_jac_zk(order: int, Gd, Gv, u, dt, x, cols, d):
    """The residual's window Jacobians in z_k width, (P, T, K, xd, d): −J with
    its columns x, u and Δt at ``cols`` = (o_x, o_u, o_t) (``o_t`` None for a
    fixed Δt, which has no column) and +0 in every other column of the
    d-wide knot; see module docstring. On the card: one pass of checks, one
    allocation and one ctypes call; the kernel's entry checks the column map
    and its own size limits and refuses a call beyond them."""
    if not _route("window_jac", x, Gv):
        return window_jac_zk_plain(order, Gd, Gv, u, dt, x, cols, d)
    P, T, K, xd = x.shape
    nd = Gv.shape[1]
    dev = x.get_device()
    for name, t, shape in (("Gd", Gd, (P, xd, xd)), ("Gv", Gv, (P, nd, xd, xd)),
                           ("u", u, (P, T, K, nd)), ("dt", dt, (P, T, K)),
                           ("x", x, (P, T, K, xd))):
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the kernel, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not _unit_last(u, x):
        raise ValueError("u and x need a unit stride on their last axis")
    out = torch.empty((P, T, K, xd, d), dtype=torch.float32, device=x.device)
    if out.numel():
        o_x, o_u, o_t = cols
        meta = _Strides20(*Gd.stride(), *Gv.stride(), *u.stride()[:3], *dt.stride(),
                          *x.stride()[:3], d, o_x, o_u, -1 if o_t is None else o_t)
        rc = _build.library().dto_window_jac(
            P, T, K, xd, nd, int(order), Gd.data_ptr(), Gv.data_ptr(), u.data_ptr(),
            dt.data_ptr(), x.data_ptr(), ctypes.addressof(meta), out.data_ptr(),
            _build.stream_ptr(dev),
        )
        # error 1 (invalid value): P·T·K or a view's offsets beyond 2^31 − 1,
        # columns outside the knot or overlapping, or d too wide for the tile
        _build.check_rc(rc, f"window_jac on {P} x {T} x {K}, d={d}")
        _count("window_jac", xd, nd)
    return out


def _res_launch(order, l1, Gd, Gv, u, dt, x, xn):
    """Check a residual-chain call on the card and launch it: one
    allocation, one ctypes call. The kernel's entry checks its own size
    limits and refuses a call beyond them."""
    P, T, K, xd = x.shape
    nd = Gv.shape[1]
    dev = x.get_device()
    for name, t, shape in (("Gd", Gd, (P, xd, xd)), ("Gv", Gv, (P, nd, xd, xd)),
                           ("u", u, (P, T, K, nd)), ("dt", dt, (P, T, K)),
                           ("x", x, (P, T, K, xd)), ("xn", xn, (P, T, K, xd))):
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the kernel, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not _unit_last(u, x, xn):
        raise ValueError("u, x and xn need a unit stride on their last axis")
    out = torch.empty((P, T) if l1 else (P, T, K, xd), dtype=torch.float32, device=x.device)
    if out.numel():
        strides = _Strides19(*Gd.stride(), *Gv.stride(), *u.stride()[:3], *dt.stride(),
                             *x.stride()[:3], *xn.stride()[:3])
        rc = _build.library().dto_residual(
            P, T, K, xd, nd, int(order), int(l1), Gd.data_ptr(), Gv.data_ptr(), u.data_ptr(),
            dt.data_ptr(), x.data_ptr(), xn.data_ptr(), ctypes.addressof(strides),
            out.data_ptr(), _build.stream_ptr(dev),
        )
        # error 1 (invalid value): P·T·K or a view's offsets beyond 2^31 − 1, or
        # the L1 form's partials beyond the kernel's shared memory
        _build.check_rc(rc, f"{'residual_l1' if l1 else 'residual_action'} on {P} x {T} x {K}")
        _count("residual_l1" if l1 else "residual", xd, nd)
    return out


def residual_action(order: int, Gd, Gv, u, dt, x, xn):
    """Residuals (P, T, K, xd); see module docstring."""
    if not _route("residual", x, Gv):
        return residual_action_plain(order, Gd, Gv, u, dt, x, xn)
    return _res_launch(order, False, Gd, Gv, u, dt, x, xn)


def residual_l1(order: int, Gd, Gv, u, dt, x, xn):
    """Per-instance ``Σ|residual|`` (P, T); see module docstring."""
    if not _route("residual_l1", x, Gv):
        return residual_l1_plain(order, Gd, Gv, u, dt, x, xn)
    return _res_launch(order, True, Gd, Gv, u, dt, x, xn)
