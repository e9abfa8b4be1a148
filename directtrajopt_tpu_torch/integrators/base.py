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
"""

from __future__ import annotations

import torch
from torch.func import grad, jvp, vmap

from ..trajectory import Layout

__all__ = [
    "windows",
    "stack_residuals",
    "stack_residuals_l1",
    "stack_jacobians_zk",
    "stack_hessians_zk",
]


def windows(zmat: torch.Tensor) -> torch.Tensor:
    """Adjacent knots: ``(..., N, dim) -> (..., N-1, 2*dim)`` rows [z_k; z_{k+1}]."""
    return torch.cat([zmat[..., :-1, :], zmat[..., 1:, :]], dim=-1)


def stack_residuals(integrator, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
    """All window residuals ``(B, ..., N-1, x_dim)``."""
    custom = getattr(integrator, "residuals_stacked", None)
    if custom is not None:
        out = custom(layout, zmat)
        if out is not None:
            return out
    return integrator.residual(layout, zmat[..., :-1, :], zmat[..., 1:, :])


def stack_residuals_l1(integrator, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
    """``Σ|residual|`` over all windows: ``(B, ...)``."""
    custom = getattr(integrator, "residuals_l1_stacked", None)
    if custom is not None:
        out = custom(layout, zmat)
        if out is not None:
            return out
    return stack_residuals(integrator, layout, zmat).abs().sum((-2, -1))


def stack_jacobians_zk(integrator, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
    """Per-window ``∂residual/∂z_k``: ``(B, N-1, r, dim)``."""
    custom = getattr(integrator, "jacobians_zk_stacked", None)
    if custom is not None:
        out = custom(layout, zmat)
        if out is not None:
            return out
    zk, zk1 = zmat[..., :-1, :], zmat[..., 1:, :]
    d = layout.dim
    eye = torch.eye(d, dtype=zmat.dtype, device=zmat.device)

    def col(e):
        return jvp(lambda z: integrator.residual(layout, z, zk1), (zk,),
                   (e.expand_as(zk),))[1]

    return vmap(col, out_dims=-1)(eye)


def stack_hessians_zk(
    integrator, layout: Layout, zmat: torch.Tensor, mu: torch.Tensor
) -> torch.Tensor:
    """Per-window Hessians of ``μ_k·residual_k`` w.r.t. ``z_k``:
    ``(B, N-1, dim, dim)``; ``mu`` is (B, N-1, x_dim)."""
    zk, zk1 = zmat[..., :-1, :], zmat[..., 1:, :]
    d = layout.dim
    eye = torch.eye(d, dtype=zmat.dtype, device=zmat.device)

    def lagr(z):
        return (mu * integrator.residual(layout, z, zk1)).sum()

    g = grad(lagr)

    def col(e):
        return jvp(g, (zk,), (e.expand_as(zk),))[1]

    return vmap(col, out_dims=-1)(eye)
