"""Time-dependent bilinear integrator and general explicit-ODE integrator.

Counterpart of ``directtrajopt_tpu/integrators/time_dependent.py``.

``TimeDependentBilinearIntegrator``: residual
``x_{k+1} − ODESolve(ẋ = Δt·G(u(τ), t_k + τΔt)·x, τ ∈ [0, 1])`` with the
control interpolated at spline order 0 (u_k) or 1 (linear between u_k and
u_{k+1}, which couples the residual to both knots), solved by ``n_steps``
fixed RK4 steps. The generator ``G(u, t)`` is a torch function of one
knot's u and one scalar t, returning (x_dim, x_dim) in u's dtype; the port
maps each window's whole RK4 chain over every window of every lane with
``torch.func.vmap``. ``td_integration_error`` is the step-doubling error
estimate of that chain and ``tune_n_steps`` picks the smallest
power-of-two multiple of ``n_steps`` that meets a tolerance.

``GeneralIntegrator``: arbitrary explicit dynamics ``ẋ = f(x, u)``
(cartpole-class problems) discretized by one Euler or one classic RK4 step
per window. ``f`` is a torch function of ONE knot's state and control (no
lane axis), as the JAX package's is, mapped the same way, so the generic
``torch.func`` Jacobians and Hessians of ``integrators/base.py`` serve it
unchanged.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from ..module import module
from ..trajectory import Layout

__all__ = [
    "TimeDependentBilinearIntegrator",
    "GeneralIntegrator",
    "rk4_step",
    "td_integration_error",
    "tune_n_steps",
]


def rk4_step(f: Callable, x: torch.Tensor, h, *args) -> torch.Tensor:
    """One classic Runge-Kutta step of ``ẋ = f(x, *args)`` with step ``h``."""
    k1 = f(x, *args)
    k2 = f(x + 0.5 * h * k1, *args)
    k3 = f(x + 0.5 * h * k2, *args)
    k4 = f(x + h * k3, *args)
    return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


@module
class TimeDependentBilinearIntegrator:
    """``x_{k+1} = ODESolve(ẋ = G(u(τ), t)·x)`` with spline-interpolated u."""

    G_fn: Callable
    x_name: str
    u_name: str
    t_name: str = "t"
    spline_order: int = 1
    n_steps: int = 10
    # ``u_{k+1} = u_next_fn(layout, z_k)`` (B, ..., K, u_dim), installed by
    # the Riccati lowering (``solvers.solve._lower_order1_td``) when another
    # explicit integrator already determines u_{k+1} from z_k (a u→du
    # derivative chain): the order-1 residual then reads z_k and the target
    # x only, the x_{k+1} − F(z_k) form of the Riccati core. Exact: both
    # constraint systems have the same solutions. Set only on the problem a
    # solve lowers, never on the one it returns.
    u_next_fn: Callable | None = None

    @staticmethod
    def create(G: Callable, x_name: str, u_name: str, t_name: str, traj=None, *,
               spline_order: int = 1, n_steps: int = 10) -> "TimeDependentBilinearIntegrator":
        if spline_order not in (0, 1):
            raise ValueError(f"unsupported spline order {spline_order}")
        return TimeDependentBilinearIntegrator(G_fn=G, x_name=x_name, u_name=u_name,
                                               t_name=t_name, spline_order=spline_order,
                                               n_steps=n_steps)

    @property
    def explicit(self) -> bool:
        # order 1 couples u_{k+1}, breaking the x_{k+1} − F(z_k) form the
        # Riccati core needs, unless the substitution removed that coupling
        return self.spline_order == 0 or self.u_next_fn is not None

    def residual_dim(self, layout: Layout) -> int:
        return layout.dim_of(self.x_name)

    def read_cols(self, layout: Layout) -> list:
        """z_k columns the residual reads (x, u, t and a free Δt); all of
        them under the substitution, which may read any column the chain
        reads."""
        if self.u_next_fn is not None:
            return list(range(layout.dim))
        cs_x, cs_u = layout.comp_slice(self.x_name), layout.comp_slice(self.u_name)
        cs_t = layout.comp_slice(self.t_name)
        cols = (list(range(cs_x.start, cs_x.stop)) + list(range(cs_u.start, cs_u.stop))
                + list(range(cs_t.start, cs_t.stop)))
        if layout.has_free_time:
            cols.append(layout.offsets[layout.timestep])
        return cols

    def read_cols_next(self, layout: Layout) -> list:
        """z_{k+1} columns: x always; u too at spline order 1 without the
        substitution."""
        cs_x = layout.comp_slice(self.x_name)
        cols = list(range(cs_x.start, cs_x.stop))
        if self.spline_order == 1 and self.u_next_fn is None:
            cs_u = layout.comp_slice(self.u_name)
            cols += list(range(cs_u.start, cs_u.stop))
        return cols

    def _window(self, x, u0, u1, t0, dt):
        """One window's RK4 chain: the state after ``n_steps`` steps, (x_dim,)."""
        if self.spline_order == 0:
            def u_of(tau):
                return u0
        else:
            def u_of(tau):
                return u0 + tau * (u1 - u0)

        h = 1.0 / self.n_steps

        def ode(y, tau):
            return dt * (self.G_fn(u_of(tau), t0 + tau * dt) @ y)

        y = x
        for i in range(self.n_steps):
            tau0 = i * h
            k1 = ode(y, tau0)
            k2 = ode(y + 0.5 * h * k1, tau0 + 0.5 * h)
            k3 = ode(y + 0.5 * h * k2, tau0 + 0.5 * h)
            k4 = ode(y + h * k3, tau0 + h)
            y = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return y

    def residual(self, layout: Layout, zk: torch.Tensor, zk1: torch.Tensor) -> torch.Tensor:
        """Residuals of the windows ``(z_k, z_{k+1})`` (..., dim) → (..., x_dim)."""
        x = layout.knot_extract(zk, self.x_name)
        x_next = layout.knot_extract(zk1, self.x_name)
        u0 = layout.knot_extract(zk, self.u_name)
        t0 = layout.knot_extract(zk, self.t_name)[..., 0]
        dt = layout.knot_timestep(zk)
        if self.spline_order == 0:
            u1 = u0
        elif self.u_next_fn is not None:
            u1 = self.u_next_fn(layout, zk)
        else:
            u1 = layout.knot_extract(zk1, self.u_name)
        lead = x.shape[:-1]

        def flat(a):
            return a.reshape((-1,) + a.shape[len(lead):])

        y = vmap(self._window)(flat(x), flat(u0), flat(u1), flat(t0), flat(dt))
        return x_next - y.reshape(x.shape)

    def __repr__(self):
        return (f"TimeDependentBilinearIntegrator: {self.x_name} = ODESolve(G({self.u_name}(τ), "
                f"{self.t_name})) (order {self.spline_order})")


def td_integration_error(integ: TimeDependentBilinearIntegrator, layout: Layout,
                         zmat: torch.Tensor) -> torch.Tensor:
    """Per-window RK4 truncation-error estimate by step doubling: with RK4's
    O(h⁴) local order, ``err ≈ ‖y_n − y_2n‖∞ / 15`` (Richardson). Knot
    matrices (B, N, dim) → (B, N−1)."""
    zk, zk1 = zmat[..., :-1, :], zmat[..., 1:, :]
    r1 = integ.residual(layout, zk, zk1)
    r2 = integ.replace(n_steps=2 * integ.n_steps).residual(layout, zk, zk1)
    # residual = x_next − y, so r1 − r2 = y_2n − y_n
    return (r1 - r2).abs().amax(-1) / 15.0


def tune_n_steps(integ: TimeDependentBilinearIntegrator, traj, *, atol: float = 1e-3,
                 start: int | None = None,
                 max_n_steps: int = 640) -> tuple[TimeDependentBilinearIntegrator, float]:
    """The smallest power-of-two multiple of ``n_steps`` (or of ``start``)
    whose step-doubling estimate on ``traj`` meets ``atol`` on every window
    of every lane, capped at ``max_n_steps``. The estimate is taken at the
    given trajectory: pass a representative one (bound-saturated controls,
    say) for a conservative choice. Returns ``(integrator, max estimate)``."""
    zmat = traj.knot_matrix()
    n = start if start is not None else integ.n_steps
    while True:
        cand = integ.replace(n_steps=n)
        e = float(td_integration_error(cand, traj.layout, zmat).max())
        if e <= atol or n >= max_n_steps:
            return cand, e
        n *= 2


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
