"""Nonlinear constraints: knot-point, global, and global-knot-point.

Counterpart of ``directtrajopt_tpu/constraints/nonlinear.py``:

* ``NonlinearKnotPointConstraint`` — a user function ``g`` over named
  variables at each knot ``t ∈ times`` with an ``equality`` flag (``g = 0``
  or ``g ≤ 0``) and optional per-time parameters. The calling convention
  (one argument per variable, or one concatenated vector) is detected by a
  trial call, as in the JAX package.
* ``NonlinearGlobalConstraint`` — ``g(globals)`` once per problem.
* ``NonlinearGlobalKnotPointConstraint`` — ``g([vars_t; globals], p_t)`` at
  each selected knot.

``g`` is a torch function of ONE knot's (or one global block's) variables,
with no lane axis; the port maps it over knots and lanes with
``torch.func.vmap``, and its Jacobians and Hessians come from
``torch.func``. Global blocks are ``(B, ..., global_dim)`` beside the knot
matrices ``(B, ..., N, dim)``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import vmap

from ..module import module
from ..trajectory import Layout, Trajectory
from .base import NonlinearConstraintBase

__all__ = [
    "NonlinearKnotPointConstraint",
    "NonlinearGlobalConstraint",
    "NonlinearGlobalKnotPointConstraint",
]


def _map_knots(params, fn, zsel: torch.Tensor, *extra):
    """``fn(z, p, *extra_i)`` on every selected knot of every lane: ``zsel``
    (B, ..., T, d); ``params`` (B, T, ...) or None; each ``extra``
    (B, ..., T, ·)."""
    lead = zsel.shape[:-1]
    M = int(np.prod(lead))
    z2 = zsel.reshape(M, zsel.shape[-1])
    ex = [e.reshape((M,) + e.shape[len(lead):]) for e in extra]
    if params is not None:
        p = params.reshape(params.shape[:1] + (1,) * (len(lead) - 2) + params.shape[1:])
        p = p.expand(lead + params.shape[2:]).reshape((M,) + params.shape[2:])
        out = vmap(fn)(z2, p.to(zsel.dtype), *ex)
    else:
        out = vmap(lambda z, *e: fn(z, None, *e))(z2, *ex)
    return out.reshape(lead + out.shape[1:])


def _knot_globals(zsel: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The global blocks ``g`` (B, ..., n_g) repeated for every selected knot
    of ``zsel`` (B, ..., T, d): (B, ..., T, n_g), a view."""
    return g[..., None, :].expand(zsel.shape[:-1] + g.shape[-1:])


def _detect_convention(g, var_dims, sample_param, takes_params) -> str:
    """Trial-call ``g`` to find its calling convention: 'separate' or 'concat'."""
    p = [sample_param] if takes_params else []
    if len(var_dims) == 1:
        return "concat"  # single variable: both conventions coincide
    zeros = [torch.zeros(d, dtype=torch.float64) for d in var_dims]
    try:
        torch.as_tensor(g(*(zeros + p)))
        return "separate"
    except (TypeError, ValueError, RuntimeError):
        pass
    torch.as_tensor(g(*([torch.zeros(sum(var_dims), dtype=torch.float64)] + p)))
    return "concat"


@module
class NonlinearKnotPointConstraint(NonlinearConstraintBase):
    """``g(vars_t[, p_t]) {=,≤} 0`` at each selected knot."""

    params: torch.Tensor | None  # (B, T, ...) per-lane, per-time parameters
    g: Callable
    var_names: tuple
    times: tuple
    g_dim: int
    equality: bool = True
    convention: str = "concat"
    takes_params: bool = False

    @staticmethod
    def create(g: Callable, names: str | Sequence[str], traj: Trajectory,
               params: Sequence | None = None, *, equality: bool = True,
               times: Sequence[int] | None = None) -> "NonlinearKnotPointConstraint":
        names = (names,) if isinstance(names, str) else tuple(names)
        times = tuple(range(traj.N)) if times is None else tuple(int(t) for t in times)
        takes_params = params is not None
        if takes_params and len(params) != len(times):
            raise ValueError("params must have the same length as times")
        ref = traj.data[names[0]]
        params_t = None
        if takes_params:
            p = np.stack([np.asarray(v, dtype=np.float64) for v in params])
            params_t = torch.as_tensor(np.broadcast_to(p, (traj.B,) + p.shape).copy(),
                                       dtype=ref.dtype, device=ref.device)
        sample = params_t[0, 0].to("cpu", torch.float64) if takes_params else None
        convention = _detect_convention(g, [traj.dims[n] for n in names], sample, takes_params)
        vals0 = [traj.data[n][0, times[0]].to("cpu", torch.float64) for n in names]
        p0 = [sample] if takes_params else []
        out0 = g(*(vals0 + p0)) if convention == "separate" else g(*([torch.cat(vals0)] + p0))
        return NonlinearKnotPointConstraint(
            params=params_t, g=g, var_names=names, times=times,
            g_dim=int(torch.as_tensor(out0).reshape(-1).shape[0]), equality=equality,
            convention=convention, takes_params=takes_params,
        )

    def knot_residual(self, layout: Layout, z: torch.Tensor, p=None, g=None) -> torch.Tensor:
        """Residual (g_dim,) at one knot vector ``z`` (d,) with its params
        (the global block ``g`` is not read)."""
        vars_ = [layout.knot_extract(z, n) for n in self.var_names]
        ps = [p] if self.takes_params else []
        if self.convention == "separate":
            out = self.g(*(vars_ + ps))
        else:
            out = self.g(*([torch.cat(vars_)] + ps))
        return torch.as_tensor(out).reshape(-1)

    def map_knots(self, fn, zsel: torch.Tensor, *extra):
        """Apply ``fn(z, p, *extra_i)`` to every selected knot of every lane:
        ``zsel`` (B, ..., T, d); each ``extra`` (B, ..., T, ·) — the
        per-knot helper behind residuals, Jacobians and Hessians."""
        return _map_knots(self.params if self.takes_params else None, fn, zsel, *extra)

    def knot_residuals(self, layout: Layout, zsel: torch.Tensor) -> torch.Tensor:
        """Residuals (B, ..., T, g_dim) at the selected knots ``zsel``."""
        return self.map_knots(lambda z, p: self.knot_residual(layout, z, p), zsel)

    def constraint_dim(self, layout: Layout) -> int:
        return self.g_dim * len(self.times)

    def evaluate_flat(self, layout: Layout, zmat: torch.Tensor, g=None) -> torch.Tensor:
        """All residuals (B, ..., T·g_dim) from knot matrices (B, ..., N, d)."""
        out = self.knot_residuals(layout, zmat[..., list(self.times), :])
        return out.reshape(out.shape[:-2] + (-1,))

    def __repr__(self):
        kind = "=" if self.equality else "≤"
        return f"NonlinearKnotPointConstraint g{kind}0 on {list(self.var_names)}"


def _global_values(traj: Trajectory, names) -> torch.Tensor:
    """Lane 0's values of the named global components, on the CPU in float64
    (for a trial call of ``g``)."""
    return torch.cat([traj.global_data[n][0].to("cpu", torch.float64) for n in names])


@module
class NonlinearGlobalConstraint(NonlinearConstraintBase):
    """``g(globals) {=,≤} 0`` once per problem."""

    g: Callable
    global_names: tuple
    g_dim: int
    equality: bool = True

    @staticmethod
    def create(g: Callable, names: str | Sequence[str], traj: Trajectory, *,
               equality: bool = True) -> "NonlinearGlobalConstraint":
        names = (names,) if isinstance(names, str) else tuple(names)
        g_dim = int(torch.as_tensor(g(_global_values(traj, names))).reshape(-1).shape[0])
        return NonlinearGlobalConstraint(g=g, global_names=names, g_dim=g_dim,
                                         equality=equality)

    def global_residual(self, layout: Layout, gv: torch.Tensor) -> torch.Tensor:
        """Residual (g_dim,) of one global block ``gv`` (global_dim,)."""
        return torch.as_tensor(self.g(layout.global_extract(gv, self.global_names))).reshape(-1)

    def constraint_dim(self, layout: Layout) -> int:
        return self.g_dim

    def evaluate_flat(self, layout: Layout, zmat: torch.Tensor, g=None) -> torch.Tensor:
        """Residuals (B, ..., g_dim) of the global blocks ``g`` (B, ..., n_g)."""
        flat = g.reshape(-1, g.shape[-1])
        out = vmap(lambda gv: self.global_residual(layout, gv))(flat)
        return out.reshape(g.shape[:-1] + out.shape[1:])

    def __repr__(self):
        kind = "=" if self.equality else "≤"
        return f"NonlinearGlobalConstraint g{kind}0 on {list(self.global_names)}"


@module
class NonlinearGlobalKnotPointConstraint(NonlinearConstraintBase):
    """``g([vars_t; globals][, p_t]) {=,≤} 0`` at each selected knot; ``g``
    takes one concatenated vector (and the knot's parameters)."""

    params: torch.Tensor | None  # (B, T, ...) per-lane, per-time parameters
    g: Callable
    var_names: tuple
    global_names: tuple
    times: tuple
    g_dim: int
    equality: bool = True
    takes_params: bool = False

    @staticmethod
    def create(g: Callable, names: str | Sequence[str], global_names: str | Sequence[str],
               traj: Trajectory, params: Sequence | None = None, *, equality: bool = True,
               times: Sequence[int] | None = None) -> "NonlinearGlobalKnotPointConstraint":
        names = (names,) if isinstance(names, str) else tuple(names)
        global_names = (global_names,) if isinstance(global_names, str) else tuple(global_names)
        times = tuple(range(traj.N)) if times is None else tuple(int(t) for t in times)
        takes_params = params is not None
        if takes_params and len(params) != len(times):
            raise ValueError("params must have the same length as times")
        ref = traj.data[names[0]]
        params_t = None
        if takes_params:
            p = np.stack([np.asarray(v, dtype=np.float64) for v in params])
            params_t = torch.as_tensor(np.broadcast_to(p, (traj.B,) + p.shape).copy(),
                                       dtype=ref.dtype, device=ref.device)
        vals0 = torch.cat([traj.data[n][0, times[0]].to("cpu", torch.float64) for n in names]
                          + [_global_values(traj, global_names)])
        p0 = [params_t[0, 0].to("cpu", torch.float64)] if takes_params else []
        g_dim = int(torch.as_tensor(g(*([vals0] + p0))).reshape(-1).shape[0])
        return NonlinearGlobalKnotPointConstraint(
            params=params_t, g=g, var_names=names, global_names=global_names, times=times,
            g_dim=g_dim, equality=equality, takes_params=takes_params,
        )

    @property
    def uses_global(self) -> bool:
        return True

    def knot_residual(self, layout: Layout, z: torch.Tensor, p=None, g=None) -> torch.Tensor:
        """Residual (g_dim,) at one knot vector ``z`` (d,) and the lane's
        global block ``g`` (global_dim,)."""
        vals = torch.cat([layout.knot_extract(z, n) for n in self.var_names]
                         + [layout.global_extract(g, self.global_names)])
        ps = [p] if self.takes_params else []
        return torch.as_tensor(self.g(*([vals] + ps))).reshape(-1)

    def map_knots(self, fn, zsel: torch.Tensor, *extra):
        """As :meth:`NonlinearKnotPointConstraint.map_knots`."""
        return _map_knots(self.params if self.takes_params else None, fn, zsel, *extra)

    def constraint_dim(self, layout: Layout) -> int:
        return self.g_dim * len(self.times)

    def evaluate_flat(self, layout: Layout, zmat: torch.Tensor, g=None) -> torch.Tensor:
        """All residuals (B, ..., T·g_dim) from knot matrices (B, ..., N, d)
        and global blocks (B, ..., n_g)."""
        zsel = zmat[..., list(self.times), :]
        out = self.map_knots(lambda z, p, gv: self.knot_residual(layout, z, p, gv), zsel,
                             _knot_globals(zsel, g))
        return out.reshape(out.shape[:-2] + (-1,))

    def __repr__(self):
        kind = "=" if self.equality else "≤"
        return (f"NonlinearGlobalKnotPointConstraint g{kind}0 on {list(self.var_names)} + "
                f"{list(self.global_names)}")
