"""Derivative integrator: ``x_{k+1} − x_k − Δt_k·ẋ_k = 0``.

Counterpart of ``directtrajopt_tpu/integrators/derivative.py``: chains
control derivatives (u → du → ddu).
"""

from __future__ import annotations

import torch

from ..module import module
from ..trajectory import Layout

__all__ = ["DerivativeIntegrator"]


@module
class DerivativeIntegrator:
    """``x_{k+1} = x_k + Δt ẋ_k``; explicit (residual ``x_{k+1} − F(z_k)``)."""

    explicit = True

    x_name: str
    xdot_name: str

    @staticmethod
    def create(x_name: str, xdot_name: str) -> "DerivativeIntegrator":
        return DerivativeIntegrator(x_name=x_name, xdot_name=xdot_name)

    def residual_dim(self, layout: Layout) -> int:
        return layout.dim_of(self.x_name)

    def read_cols(self, layout: Layout) -> list:
        """z_k columns the residual reads (x, ẋ and a free Δt)."""
        cs_x = layout.comp_slice(self.x_name)
        cs_d = layout.comp_slice(self.xdot_name)
        cols = list(range(cs_x.start, cs_x.stop)) + list(range(cs_d.start, cs_d.stop))
        if layout.has_free_time:
            cols.append(layout.offsets[layout.timestep])
        return cols

    def hessian_zk(self, layout: Layout, zk: torch.Tensor, zk1: torch.Tensor,
                   mu: torch.Tensor) -> torch.Tensor:
        """Closed-form Hessian of ``μᵀ(x_{k+1} − x_k − Δt·ẋ_k)`` w.r.t. ``z_k``
        per window, (B, K, d, d): the only curvature is the Δt × ẋ cross term
        (−μᵢ at (Δt, ẋᵢ)); zero for a fixed Δt."""
        d = layout.dim
        H = zk.new_zeros(zk.shape[:-1] + (d, d))
        if not layout.has_free_time:
            return H
        e_dt = zk.new_zeros((d,))
        e_dt[layout.offsets[layout.timestep]] = 1.0
        v = zk.new_zeros(zk.shape[:-1] + (d,))
        v[..., layout.comp_slice(self.xdot_name)] = -mu
        return e_dt[:, None] * v[..., None, :] + v[..., :, None] * e_dt

    def residual(self, layout: Layout, zk: torch.Tensor, zk1: torch.Tensor) -> torch.Tensor:
        x = layout.knot_extract(zk, self.x_name)
        x_next = layout.knot_extract(zk1, self.x_name)
        xdot = layout.knot_extract(zk, self.xdot_name)
        dt = layout.knot_timestep(zk)
        return x_next - x - dt[..., None] * xdot

    def __repr__(self) -> str:
        return f"DerivativeIntegrator: {self.x_name} += Δt * {self.xdot_name}"
