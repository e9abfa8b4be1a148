"""Carry problems and warm starts over from the JAX package.

``from_numpy_problem`` builds the port's problem from a
``directtrajopt_tpu`` problem so that both packages solve the very same
problem: every array leaf is read through numpy (copied) and the static
metadata (names, dims, timestep name, orders, knot indices) is read off the
objects' attributes. This module never imports ``jax``.

A JAX problem built unbatched becomes a port problem with one lane; a
batched one (leading axis on every leaf, e.g. from
``make_batched_bilinear_problems``) keeps its lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from .constraints import BoundsConstraint, EqualityConstraint
from .integrators import BilinearIntegrator, DerivativeIntegrator
from .objectives import CompositeObjective, QuadraticRegularizer
from .precision import check_device
from .problem import DirectTrajOptProblem
from .solvers.ipm import WarmStart
from .trajectory import Trajectory

__all__ = ["from_numpy_problem", "from_numpy_warm"]


def _lanes(x, B: int, rank: int, device, dtype) -> torch.Tensor:
    """Host array of per-problem rank ``rank`` → (B, ...) tensor."""
    a = np.array(x, dtype=np.float64)
    if a.ndim == rank:
        a = np.broadcast_to(a, (B,) + a.shape).copy()
    return torch.as_tensor(a, dtype=dtype, device=device)


def _objective(obj, B, device, dtype):
    kind = type(obj).__name__
    if kind == "CompositeObjective":
        return CompositeObjective(
            objectives=tuple(_objective(o, B, device, dtype) for o in obj.objectives),
            weights=tuple(float(w) for w in obj.weights),
        )
    if kind == "QuadraticRegularizer":
        return QuadraticRegularizer(
            R=_lanes(obj.R, B, 1, device, dtype),
            baseline=_lanes(obj.baseline, B, 2, device, dtype),
            mask=_lanes(obj.mask, B, 1, device, dtype),
            name=obj.name,
        )
    raise NotImplementedError(f"objective {kind} is not ported yet (ROADMAP Queue 1 item 10)")


def _integrator(integ, B, device, dtype):
    kind = type(integ).__name__
    if kind == "BilinearIntegrator":
        if integ.G_fn is not None or integ.method != "taylor":
            raise NotImplementedError("only the Taylor method with array generators is "
                                      "ported (ROADMAP Queue 1 item 12)")
        return BilinearIntegrator(
            G_drift=_lanes(integ.G_drift, B, 2, device, dtype),
            G_drives=_lanes(integ.G_drives, B, 3, device, dtype),
            x_name=integ.x_name, u_name=integ.u_name,
            method="taylor", taylor_order=int(integ.taylor_order),
        )
    if kind == "DerivativeIntegrator":
        return DerivativeIntegrator(x_name=integ.x_name, xdot_name=integ.xdot_name)
    raise NotImplementedError(f"integrator {kind} is not ported yet (ROADMAP Queue 1 item 12)")


def _constraint(con, B, device, dtype):
    kind = type(con).__name__
    if kind == "EqualityConstraint":
        vals = np.array(con.values, dtype=np.float64).reshape(B, -1)
        return EqualityConstraint(
            values=torch.as_tensor(np.ascontiguousarray(vals), dtype=dtype, device=device),
            name=con.name, times=tuple(int(t) for t in con.times), label=con.label,
        )
    if kind == "BoundsConstraint":
        return BoundsConstraint(
            lb=_lanes(con.lb, B, 1, device, dtype), ub=_lanes(con.ub, B, 1, device, dtype),
            name=con.name, times=tuple(int(t) for t in con.times),
            subcomponents=None if con.subcomponents is None else tuple(con.subcomponents),
            label=con.label,
        )
    raise NotImplementedError(f"constraint {kind} is not ported yet (ROADMAP Queue 1 item 9)")


def from_numpy_problem(jax_problem, device, dtype=torch.float64) -> DirectTrajOptProblem:
    """The port's problem for a ``directtrajopt_tpu`` problem (see module doc)."""
    device = check_device(device)
    jt = jax_problem.trajectory
    if jt.global_names:
        raise NotImplementedError("global variables are not ported yet (ROADMAP Queue 1 item 9)")
    first = np.asarray(jt.data[jt.names[0]])
    B = first.shape[0] if first.ndim == 3 else 1
    traj = Trajectory(
        data={n: _lanes(jt.data[n], B, 2, device, dtype) for n in jt.names},
        initial={k: _lanes(v, B, 1, device, dtype) for k, v in jt.initial.items()},
        final={k: _lanes(v, B, 1, device, dtype) for k, v in jt.final.items()},
        goal={k: _lanes(v, B, 1, device, dtype) for k, v in jt.goal.items()},
        bounds={k: (_lanes(lb, B, 1, device, dtype), _lanes(ub, B, 1, device, dtype))
                for k, (lb, ub) in jt.bounds.items()},
        names=tuple(jt.names),
        timestep=jt.timestep,
        controls=tuple(jt.controls),
    )
    return DirectTrajOptProblem(
        trajectory=traj,
        objective=_objective(jax_problem.objective, B, device, dtype),
        integrators=tuple(_integrator(i, B, device, dtype) for i in jax_problem.integrators),
        constraints=tuple(_constraint(c, B, device, dtype) for c in jax_problem.constraints),
    )


def from_numpy_warm(warm, device, dtype=torch.float64) -> WarmStart:
    """The port's :class:`WarmStart` for a JAX ``WarmStart`` (batched or one lane)."""
    device = check_device(device)

    def t(x):
        a = np.array(x, dtype=np.float64)
        if a.ndim == 1:
            a = a[None]
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return WarmStart(s=t(warm.s), lam=t(warm.lam), nu=t(warm.nu), zL=t(warm.zL), zU=t(warm.zU))
