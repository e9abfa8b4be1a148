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

    def residual(self, layout: Layout, zk: torch.Tensor, zk1: torch.Tensor) -> torch.Tensor:
        x = layout.knot_extract(zk, self.x_name)
        x_next = layout.knot_extract(zk1, self.x_name)
        xdot = layout.knot_extract(zk, self.xdot_name)
        dt = layout.knot_timestep(zk)
        return x_next - x - dt[..., None] * xdot

    def __repr__(self) -> str:
        return f"DerivativeIntegrator: {self.x_name} += Δt * {self.xdot_name}"
