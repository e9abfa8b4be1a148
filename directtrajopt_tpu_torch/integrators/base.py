"""Integrator interface: dynamics as batched two-knot window residuals.

Counterpart of ``directtrajopt_tpu/integrators/base.py``. An integrator
exposes

    residual(layout, zk, zk1) -> (..., x_dim)

on the knot pairs ``(z_k, z_{k+1})`` of all windows at once (the JAX
package's per-window ``residual`` under ``vmap``). Every explicit
integrator's residual is ``x_{k+1} − F(z_k)``, so the Riccati backend needs
only the derivatives with respect to ``z_k``:

* ``stack_jacobians_zk`` — (B, N−1, r, d), through the integrator's closed
  form when it has one (the bilinear window-Jacobian kernel), otherwise by
  forward-mode AD;
* ``stack_hessians_zk`` — (B, N−1, d, d) Hessians of ``μ_k·residual_k``,
  by forward-over-reverse AD (``torch.func``). The residuals of different
  windows and lanes are independent, so one reverse pass gives every
  window's gradient and one forward tangent per coordinate (applied to all
  windows at once) gives every window's Hessian column.

The dense backend assembles over the whole 2·dim window ``[z_k; z_{k+1}]``
(an implicit integrator reads both knots):

* ``stack_jacobians`` — (B, N−1, r, 2d);
* ``stack_hessians`` — (B, N−1, 2d, 2d), from the integrator's closed-form
  ``hessian_zk`` padded to the window when it has one, otherwise by AD.

Both differentiate only the window columns the residual reads
(``_window_cols``: the integrator's ``read_cols`` on z_k and its
``read_cols_next``, or the target x, on z_{k+1}), one tangent per read
column, the rows of a one-hot embedding; the other entries are zero.

The JAX package's environment gates choose the forms, read at each call
(the JAX package reads them when it traces), with its names and defaults:

* ``DTX_ZK_CUSTOM_HESS`` (unset): ``stack_hessians_zk`` takes the
  integrator's closed-form ``hessian_zk`` where it has one;
* ``DTX_ZK_READCOLS`` (unset): ``stack_jacobians_zk`` and
  ``stack_hessians_zk`` differentiate only the read columns, as the window
  functions do. Unset, both are generic full-width AD, which the JAX
  package measured as the faster form at z_k width;
* ``DTX_NO_READCOLS`` (unset): no read-column restriction anywhere;
* ``DTX_NO_CUSTOM_HESS`` (unset): ``stack_hessians`` by AD, without the
  closed form;
* ``DTX_ZK_KERNEL=0`` / ``DTX_RES_KERNEL=0`` (both "1"): the window
  Jacobians / the stacked residuals and their L1 sums by the generic route
  instead of the integrator's closed form (the window-Jacobian and
  residual kernels).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad, jvp, vmap

from ..precision import lane_sum
from ..trajectory import Layout

__all__ = [
    "windows",
    "integrator_dim",
    "evaluate",
    "stack_jacobians",
    "stack_hessians",
    "stack_residuals",
    "stack_residuals_l1",
    "stack_jacobians_zk",
    "stack_hessians_zk",
]


def windows(zmat: torch.Tensor) -> torch.Tensor:
    """Adjacent knots: ``(..., N, dim) -> (..., N-1, 2*dim)`` rows [z_k; z_{k+1}]."""
    return torch.cat([zmat[..., :-1, :], zmat[..., 1:, :]], dim=-1)


def integrator_dim(integrator, layout: Layout) -> int:
    """Total residual dimension ``x_dim·(N−1)``."""
    return integrator.residual_dim(layout) * (layout.N - 1)


def evaluate(integrator, traj) -> torch.Tensor:
    """Flat residual vectors (B, x_dim·(N−1)) of every lane of a trajectory."""
    res = stack_residuals(integrator, traj.layout, traj.knot_matrix())
    return res.reshape(res.shape[0], -1)


def stack_residuals(integrator, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
    """All window residuals ``(B, ..., N-1, x_dim)``."""
    custom = getattr(integrator, "residuals_stacked", None)
    if custom is not None and os.environ.get("DTX_RES_KERNEL", "1") != "0":
        out = custom(layout, zmat)
        if out is not None:
            return out
    return integrator.residual(layout, zmat[..., :-1, :], zmat[..., 1:, :])


def stack_residuals_l1(integrator, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
    """``Σ|residual|`` over all windows: ``(B, ...)``."""
    custom = getattr(integrator, "residuals_l1_stacked", None)
    if custom is not None and os.environ.get("DTX_RES_KERNEL", "1") != "0":
        out = custom(layout, zmat)
        if out is not None:
            return out
    return lane_sum(stack_residuals(integrator, layout, zmat).abs(), dims=2)


def stack_jacobians_zk(integrator, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
    """Per-window ``∂residual/∂z_k``: ``(B, N-1, r, dim)``."""
    custom = getattr(integrator, "jacobians_zk_stacked", None)
    if custom is not None and os.environ.get("DTX_ZK_KERNEL", "1") != "0":
        out = custom(layout, zmat)
        if out is not None:
            return out
    zk, zk1 = zmat[..., :-1, :], zmat[..., 1:, :]
    E = _zk_tangents(integrator, layout, zmat)

    def col(e):
        return jvp(lambda z: integrator.residual(layout, z, zk1), (zk,),
                   (e.expand_as(zk),))[1]

    Jr = vmap(col)(E).movedim(0, -1)  # (B, N-1, r, n_read)
    return Jr if E.shape[0] == layout.dim else Jr @ E


def stack_hessians_zk(
    integrator, layout: Layout, zmat: torch.Tensor, mu: torch.Tensor
) -> torch.Tensor:
    """Per-window Hessians of ``μ_k·residual_k`` w.r.t. ``z_k``:
    ``(B, N-1, dim, dim)``; ``mu`` is (B, N-1, x_dim)."""
    zk, zk1 = zmat[..., :-1, :], zmat[..., 1:, :]
    custom = getattr(integrator, "hessian_zk", None)
    if custom is not None and os.environ.get("DTX_ZK_CUSTOM_HESS"):
        return custom(layout, zk, zk1, mu)
    E = _zk_tangents(integrator, layout, zmat)
    full = E.shape[0] == layout.dim

    def lagr(z):
        return (mu * integrator.residual(layout, z, zk1)).sum()

    g = grad(lagr)

    def col(e):
        h = jvp(g, (zk,), (e.expand_as(zk),))[1]
        return h if full else h @ E.T

    Hr = vmap(col)(E).movedim(0, -1)  # (B, N-1, n_read, n_read)
    return Hr if full else E.T @ Hr @ E


def stack_jacobians(integrator, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
    """Per-window residual Jacobians over the 2·dim window: ``(B, N-1, r, 2*dim)``."""
    d = layout.dim
    zk, zk1 = zmat[..., :-1, :], zmat[..., 1:, :]
    E = _tangents(integrator, layout, zmat)

    def col(e):
        return jvp(lambda a, b: integrator.residual(layout, a, b), (zk, zk1),
                   (e[:d].expand_as(zk), e[d:].expand_as(zk1)))[1]

    Jr = vmap(col)(E).movedim(0, -1)  # (B, N-1, r, n_read)
    return Jr @ E


def stack_hessians(integrator, layout: Layout, zmat: torch.Tensor,
                   mu: torch.Tensor) -> torch.Tensor:
    """Per-window Hessians of ``μ_k·residual_k`` over the 2·dim window:
    ``(B, N-1, 2*dim, 2*dim)``; ``mu`` is (B, N-1, x_dim)."""
    d = layout.dim
    zk, zk1 = zmat[..., :-1, :], zmat[..., 1:, :]
    # explicit integrators are linear in z_{k+1}: the whole window Hessian is
    # the z_k block, which a closed-form hessian_zk gives directly
    custom = getattr(integrator, "hessian_zk", None)
    if custom is not None and not os.environ.get("DTX_NO_CUSTOM_HESS"):
        return F.pad(custom(layout, zk, zk1, mu), (0, d, 0, d))
    E = _tangents(integrator, layout, zmat)
    g = grad(lambda a, b: (mu * integrator.residual(layout, a, b)).sum(), argnums=(0, 1))

    def col(e):
        ga, gb = jvp(g, (zk, zk1), (e[:d].expand_as(zk), e[d:].expand_as(zk1)))[1]
        return torch.cat([ga, gb], dim=-1) @ E.T

    Hr = vmap(col)(E).movedim(0, -1)  # (B, N-1, n_read, n_read)
    return E.T @ Hr @ E


def _read_cols(integrator, layout: Layout) -> np.ndarray | None:
    """The z_k columns the integrator's residual reads (its ``read_cols``),
    or None for all of them: without ``read_cols``, when it names every
    column, or under ``DTX_NO_READCOLS``."""
    if os.environ.get("DTX_NO_READCOLS"):
        return None
    fn = getattr(integrator, "read_cols", None)
    if fn is None:
        return None
    cols = np.unique(np.asarray(fn(layout), dtype=np.int64))
    if len(cols) >= layout.dim:
        return None
    return cols


def _window_cols(integrator, layout: Layout) -> np.ndarray | None:
    """The columns the residual reads within the 2·dim window, or None for
    all: z_k's from ``read_cols``, z_{k+1}'s from ``read_cols_next`` when
    the integrator declares it (an order-1 control spline also reads
    u_{k+1}), else the target x."""
    cols_k = _read_cols(integrator, layout)
    if cols_k is None:
        return None
    fn = getattr(integrator, "read_cols_next", None)
    if fn is not None:
        nxt = np.unique(np.asarray(fn(layout), dtype=np.int64))
    else:
        x_name = getattr(integrator, "x_name", None)
        if x_name is None:
            return None
        cs = layout.comp_slice(x_name)
        nxt = np.arange(cs.start, cs.stop, dtype=np.int64)
    return np.concatenate([cols_k, layout.dim + nxt])


def _embedding(cols: np.ndarray, dim: int, dtype, device=None) -> torch.Tensor:
    """One-hot embedding ``E (n_read, dim)`` of the columns ``cols``."""
    E = np.zeros((len(cols), dim))
    E[np.arange(len(cols)), cols] = 1.0
    return torch.as_tensor(E, dtype=dtype, device=device)


def _tangents(integrator, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
    """The window AD's tangents: the rows of the read columns' embedding,
    or the identity of the whole window."""
    cols = _window_cols(integrator, layout)
    if cols is None:
        return torch.eye(2 * layout.dim, dtype=zmat.dtype, device=zmat.device)
    return _embedding(cols, 2 * layout.dim, zmat.dtype, zmat.device)


def _zk_tangents(integrator, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
    """The z_k AD's tangents: the identity of the knot's width, or under
    ``DTX_ZK_READCOLS`` the rows of the read columns' embedding."""
    cols = _read_cols(integrator, layout) if os.environ.get("DTX_ZK_READCOLS") else None
    if cols is None:
        return torch.eye(layout.dim, dtype=zmat.dtype, device=zmat.device)
    return _embedding(cols, layout.dim, zmat.dtype, zmat.device)
