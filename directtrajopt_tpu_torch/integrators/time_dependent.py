"""General explicit-ODE integrator.

Counterpart of ``GeneralIntegrator`` and ``rk4_step`` in
``directtrajopt_tpu/integrators/time_dependent.py``: arbitrary explicit
dynamics ``ẋ = f(x, u)`` (cartpole-class problems) discretized by one Euler
or one classic RK4 step per window. ``f`` is a torch function of ONE knot's
state and control (no lane axis), as the JAX package's is; the port maps
the whole window step over every window of every lane with
``torch.func.vmap``, so the generic ``torch.func`` Jacobians and Hessians of
``integrators/base.py`` serve it unchanged.

Not ported yet (ROADMAP Queue 1 item 7): ``TimeDependentBilinearIntegrator``,
``td_integration_error`` and ``tune_n_steps``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from ..module import module
from ..trajectory import Layout

__all__ = ["GeneralIntegrator", "rk4_step"]


def rk4_step(f: Callable, x: torch.Tensor, h, *args) -> torch.Tensor:
    """One classic Runge-Kutta step of ``ẋ = f(x, *args)`` with step ``h``."""
    k1 = f(x, *args)
    k2 = f(x + 0.5 * h * k1, *args)
    k3 = f(x + 0.5 * h * k2, *args)
    k4 = f(x + h * k3, *args)
    return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


@module
class GeneralIntegrator:
    """Explicit discretization of ``ẋ = f(x, u)``: Euler or RK4 step."""

    f: Callable
    x_name: str
    u_name: str
    scheme: str = "rk4"  # "euler" | "rk4"

    explicit = True

    @staticmethod
    def create(f: Callable, x_name: str, u_name: str, traj=None, *,
               scheme: str = "rk4") -> "GeneralIntegrator":
        if scheme not in ("euler", "rk4"):
            raise ValueError(f"unknown scheme {scheme}")
        return GeneralIntegrator(f=f, x_name=x_name, u_name=u_name, scheme=scheme)

    def residual_dim(self, layout: Layout) -> int:
        return layout.dim_of(self.x_name)

    def read_cols(self, layout: Layout) -> list:
        """z_k columns the residual reads (x, u and a free Δt)."""
        cs_x, cs_u = layout.comp_slice(self.x_name), layout.comp_slice(self.u_name)
        cols = list(range(cs_x.start, cs_x.stop)) + list(range(cs_u.start, cs_u.stop))
        if layout.has_free_time:
            cols.append(layout.offsets[layout.timestep])
        return cols

    def _window(self, layout: Layout, zk: torch.Tensor, zk1: torch.Tensor) -> torch.Tensor:
        """One window's residual ``x_{k+1} − step(x_k, u_k, Δt_k)``, (x_dim,)."""
        x = layout.knot_extract(zk, self.x_name)
        x_next = layout.knot_extract(zk1, self.x_name)
        u = layout.knot_extract(zk, self.u_name)
        dt = layout.knot_timestep(zk)
        if self.scheme == "euler":
            y = x + dt * self.f(x, u)
        else:
            y = rk4_step(self.f, x, dt, u)
        return x_next - y

    def residual(self, layout: Layout, zk: torch.Tensor, zk1: torch.Tensor) -> torch.Tensor:
        """Residuals of the windows ``(z_k, z_{k+1})`` (..., dim) → (..., x_dim)."""
        lead = zk.shape[:-1]
        out = vmap(lambda a, b: self._window(layout, a, b))(
            zk.reshape(-1, zk.shape[-1]), zk1.reshape(-1, zk1.shape[-1]))
        return out.reshape(lead + out.shape[-1:])

    def __repr__(self):
        return f"GeneralIntegrator({self.scheme}): {self.x_name}' = f({self.x_name}, {self.u_name})"
