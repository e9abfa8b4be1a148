"""Carry problems and warm starts over from the JAX package.

``from_numpy_problem`` builds the port's problem from a
``directtrajopt_tpu`` problem so that both packages solve the very same
problem: every array leaf is read through numpy (copied) and the static
metadata (names, dims, timestep name, orders, knot indices) is read off the
objects' attributes. This module never imports ``jax``.

A user function (a nonlinear constraint's ``g``, a knot or global
objective's ℓ, a custom HVP apply, a ``GeneralIntegrator``'s dynamics
``f``, a bilinear integrator's callable generator ``G(u)`` or a
``TimeDependentBilinearIntegrator``'s ``G(u, t)``) is JAX code and cannot
cross: ``functions`` maps
``("constraint", i)`` (index into ``problem.constraints``),
``("objective", j)`` (index into the flattened objective terms),
``("hvp", j)`` or ``("integrator", i)`` (index into
``problem.integrators``) to its torch counterpart. The global
block (``global_data`` and its bounds) crosses with the trajectory.

A JAX problem built unbatched becomes a port problem with one lane; a
batched one (leading axis on every leaf, e.g. from
``make_batched_bilinear_problems``) keeps its lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constraints as C
from . import objectives as O
from .integrators import (
    BilinearIntegrator,
    DerivativeIntegrator,
    GeneralIntegrator,
    TimeDependentBilinearIntegrator,
)
from .precision import check_device
from .problem import DirectTrajOptProblem
from .solvers.ipm import WarmStart
from .trajectory import Trajectory

__all__ = ["from_numpy_problem", "from_numpy_warm"]


def _lanes(x, B: int, batched: bool, device, dtype) -> torch.Tensor:
    """A per-problem host leaf → (B, ...): a batched problem's leaves keep
    their lane axis, an unbatched problem's are repeated over the lanes."""
    a = np.array(x, dtype=np.float64)
    if not batched:
        a = np.broadcast_to(a, (B,) + a.shape).copy()
    return torch.as_tensor(a, dtype=dtype, device=device)


def _fn(functions, key, what):
    if key not in functions:
        raise ValueError(f"{what} is a JAX function: pass its torch counterpart as "
                         f"functions[{key!r}]")
    return functions[key]


def _objective(obj, B, batched, device, dtype, functions, j=0):
    kind = type(obj).__name__
    if kind == "CompositeObjective":
        return O.CompositeObjective(
            objectives=tuple(_objective(o, B, batched, device, dtype, functions, i)
                             for i, o in enumerate(obj.objectives)),
            weights=tuple(float(w) for w in obj.weights),
        )
    if kind == "QuadraticRegularizer":
        return O.QuadraticRegularizer(
            R=_lanes(obj.R, B, batched, device, dtype),
            baseline=_lanes(obj.baseline, B, batched, device, dtype),
            mask=_lanes(obj.mask, B, batched, device, dtype),
            name=obj.name,
        )
    if kind == "LinearRegularizer":
        return O.LinearRegularizer(R=_lanes(obj.R, B, batched, device, dtype),
                                   mask=_lanes(obj.mask, B, batched, device, dtype), name=obj.name)
    if kind == "MinimumTimeObjective":
        return O.MinimumTimeObjective(D=_lanes(obj.D, B, batched, device, dtype))
    if kind == "KnotPointObjective":
        carrier = obj.hvp_carrier
        if type(carrier).__name__ == "ConstantLowRankHVP":
            carrier = O.ConstantLowRankHVP(A=_lanes(carrier.A, B, batched, device, dtype),
                                           core=_lanes(carrier.core, B, batched, device, dtype))
        elif carrier is not None:
            carrier = O.CustomKnotHVP(apply_fn=_fn(functions, ("hvp", j), "a custom HVP apply"),
                                      on_device=bool(carrier.on_device))
        return O.KnotPointObjective(
            Qs=_lanes(obj.Qs, B, batched, device, dtype),
            params=None if obj.params is None else _lanes(obj.params, B, batched, device, dtype),
            hvp_carrier=carrier, ell=_fn(functions, ("objective", j), "a knot objective's ell"),
            var_names=tuple(obj.var_names), takes_params=bool(obj.takes_params),
        )
    if kind == "NullObjective":
        return O.NullObjective()
    if kind == "GlobalObjective":
        q = np.array(obj.Q, dtype=np.float64)
        return O.GlobalObjective(
            Q=_lanes(q if batched else q.reshape(()), B, batched, device, dtype),
            ell=_fn(functions, ("objective", j), "a global objective's ell"),
            global_names=tuple(obj.global_names),
        )
    if kind == "GlobalKnotPointObjective":
        return O.GlobalKnotPointObjective(
            Qs=_lanes(obj.Qs, B, batched, device, dtype),
            params=None if obj.params is None else _lanes(obj.params, B, batched, device, dtype),
            ell=_fn(functions, ("objective", j), "a global knot objective's ell"),
            var_names=tuple(obj.var_names), global_names=tuple(obj.global_names),
            takes_params=bool(obj.takes_params),
        )
    raise TypeError(f"unknown objective {kind}")


def _integrator(integ, B, batched, device, dtype, functions, i):
    kind = type(integ).__name__
    if kind == "BilinearIntegrator":
        kw = dict(x_name=integ.x_name, u_name=integ.u_name, method=integ.method,
                  taylor_order=int(integ.taylor_order), squarings=int(integ.squarings))
        if integ.G_fn is not None:
            return BilinearIntegrator(
                G_drift=None, G_drives=None,
                G_fn=_fn(functions, ("integrator", i), "a bilinear integrator's generator"),
                **kw)
        return BilinearIntegrator(
            G_drift=_lanes(integ.G_drift, B, batched, device, dtype),
            G_drives=_lanes(integ.G_drives, B, batched, device, dtype), **kw)
    if kind == "TimeDependentBilinearIntegrator":
        return TimeDependentBilinearIntegrator(
            G_fn=_fn(functions, ("integrator", i), "a time-dependent integrator's generator"),
            x_name=integ.x_name, u_name=integ.u_name, t_name=integ.t_name,
            spline_order=int(integ.spline_order), n_steps=int(integ.n_steps))
    if kind == "DerivativeIntegrator":
        return DerivativeIntegrator(x_name=integ.x_name, xdot_name=integ.xdot_name)
    if kind == "GeneralIntegrator":
        return GeneralIntegrator(f=_fn(functions, ("integrator", i), "a general integrator's f"),
                                 x_name=integ.x_name, u_name=integ.u_name, scheme=integ.scheme)
    raise TypeError(f"unknown integrator {kind}")


def _constraint(con, B, batched, device, dtype, functions, i):
    kind = type(con).__name__
    if kind == "EqualityConstraint":
        vals = np.array(con.values, dtype=np.float64).reshape(B, -1)
        return C.EqualityConstraint(
            values=torch.as_tensor(np.ascontiguousarray(vals), dtype=dtype, device=device),
            name=con.name, times=tuple(int(t) for t in con.times), label=con.label,
        )
    if kind == "BoundsConstraint":
        return C.BoundsConstraint(
            lb=_lanes(con.lb, B, batched, device, dtype), ub=_lanes(con.ub, B, batched, device, dtype),
            name=con.name, times=tuple(int(t) for t in con.times),
            subcomponents=None if con.subcomponents is None else tuple(con.subcomponents),
            label=con.label,
        )
    if kind == "AllEqualConstraint":
        return C.AllEqualConstraint(name=con.name, component_index=int(con.component_index),
                                    label=con.label)
    if kind == "TotalConstraint":
        return C.TotalConstraint(
            value=_lanes(con.value, B, batched, device, dtype),
            name=con.name, component_index=int(con.component_index), label=con.label,
            is_eq=bool(con.is_eq), has_lb=bool(con.has_lb), has_ub=bool(con.has_ub),
        )
    if kind == "SymmetryConstraint":
        return C.SymmetryConstraint(
            name=con.name, component_indices=tuple(int(c) for c in con.component_indices),
            even=bool(con.even), include_timestep=bool(con.include_timestep), label=con.label)
    if kind == "TimeConsistencyConstraint":
        return C.TimeConsistencyConstraint(time_name=con.time_name,
                                           timestep_name=con.timestep_name, label=con.label)
    if kind == "L1SlackConstraint":
        return C.L1SlackConstraint(
            var_name=con.var_name, slack_name=con.slack_name,
            times=None if con.times is None else tuple(int(t) for t in con.times),
            label=con.label)
    if kind == "NonlinearKnotPointConstraint":
        return C.NonlinearKnotPointConstraint(
            params=None if con.params is None else _lanes(con.params, B, batched, device, dtype),
            g=_fn(functions, ("constraint", i), "a nonlinear constraint's g"),
            var_names=tuple(con.var_names), times=tuple(int(t) for t in con.times),
            g_dim=int(con.g_dim), equality=bool(con.equality), convention=con.convention,
            takes_params=bool(con.takes_params),
        )
    if kind == "GlobalEqualityConstraint":
        vals = np.array(con.values, dtype=np.float64).reshape(B if batched else 1, -1)
        return C.GlobalEqualityConstraint(
            values=torch.as_tensor(np.broadcast_to(vals, (B, vals.shape[1])).copy(), dtype=dtype,
                                   device=device),
            name=con.name, label=con.label)
    if kind == "GlobalBoundsConstraint":
        return C.GlobalBoundsConstraint(
            lb=_lanes(con.lb, B, batched, device, dtype), ub=_lanes(con.ub, B, batched, device, dtype),
            name=con.name, label=con.label)
    if kind == "GlobalLinearConstraint":
        A = np.array(con.A, dtype=np.float64)
        if batched:  # one A for all lanes stays static; a per-lane A is (B, rows, g)
            A = A[0] if np.all(A == A[:1]) else torch.as_tensor(A, dtype=dtype, device=device)
        return C.GlobalLinearConstraint(
            A=A, lb=_lanes(con.lb, B, batched, device, dtype), ub=_lanes(con.ub, B, batched, device, dtype),
            name=con.name, label=con.label, eq_mask=tuple(con.eq_mask),
            finite_lb=tuple(con.finite_lb), finite_ub=tuple(con.finite_ub))
    if kind == "NonlinearGlobalConstraint":
        return C.NonlinearGlobalConstraint(
            g=_fn(functions, ("constraint", i), "a nonlinear constraint's g"),
            global_names=tuple(con.global_names), g_dim=int(con.g_dim),
            equality=bool(con.equality))
    if kind == "NonlinearGlobalKnotPointConstraint":
        return C.NonlinearGlobalKnotPointConstraint(
            params=None if con.params is None else _lanes(con.params, B, batched, device, dtype),
            g=_fn(functions, ("constraint", i), "a nonlinear constraint's g"),
            var_names=tuple(con.var_names), global_names=tuple(con.global_names),
            times=tuple(int(t) for t in con.times), g_dim=int(con.g_dim),
            equality=bool(con.equality), takes_params=bool(con.takes_params))
    raise TypeError(f"unknown constraint {kind}")


def from_numpy_problem(jax_problem, device=None, dtype=torch.float64, *,
                       functions: dict | None = None) -> DirectTrajOptProblem:
    """The port's problem for a ``directtrajopt_tpu`` problem (see module doc)."""
    functions = functions or {}
    device = check_device(device)
    jt = jax_problem.trajectory
    first = np.asarray(jt.data[jt.names[0]])
    batched = first.ndim == 3
    B = first.shape[0] if batched else 1
    traj = Trajectory(
        data={n: _lanes(jt.data[n], B, batched, device, dtype) for n in jt.names},
        initial={k: _lanes(v, B, batched, device, dtype) for k, v in jt.initial.items()},
        final={k: _lanes(v, B, batched, device, dtype) for k, v in jt.final.items()},
        goal={k: _lanes(v, B, batched, device, dtype) for k, v in jt.goal.items()},
        bounds={k: (_lanes(lb, B, batched, device, dtype), _lanes(ub, B, batched, device, dtype))
                for k, (lb, ub) in jt.bounds.items()},
        global_data={k: _lanes(v, B, batched, device, dtype) for k, v in jt.global_data.items()},
        names=tuple(jt.names),
        global_names=tuple(jt.global_names),
        timestep=jt.timestep,
        controls=tuple(jt.controls),
    )
    return DirectTrajOptProblem(
        trajectory=traj,
        objective=_objective(jax_problem.objective, B, batched, device, dtype, functions),
        integrators=tuple(_integrator(integ, B, batched, device, dtype, functions, i)
                          for i, integ in enumerate(jax_problem.integrators)),
        constraints=tuple(_constraint(c, B, batched, device, dtype, functions, i)
                          for i, c in enumerate(jax_problem.constraints)),
    )


def from_numpy_warm(warm, device=None, dtype=torch.float64) -> WarmStart:
    """The port's :class:`WarmStart` for a JAX ``WarmStart`` (batched or one lane)."""
    device = check_device(device)

    def t(x):
        a = np.array(x, dtype=np.float64)
        if a.ndim == 1:
            a = a[None]
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return WarmStart(s=t(warm.s), lam=t(warm.lam), nu=t(warm.nu), zL=t(warm.zL), zU=t(warm.zU))
