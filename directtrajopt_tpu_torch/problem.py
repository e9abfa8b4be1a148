"""Problem container: trajectory + objective + integrators + constraints.

Counterpart of ``directtrajopt_tpu/problem.py``: the constructor extracts
the trajectory constraints (initial / final pins, bounds over the knots the
pins leave free, bounds on global components, time consistency
``t_{k+1} = t_k + Δt_k`` when a ``t`` component meets a free timestep), and
a free timestep with no bounds gets a default ``Δt ≥ 0`` lower bound with a
warning.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import torch

from .constraints import (
    BoundsConstraint,
    EqualityConstraint,
    GlobalBoundsConstraint,
    TimeConsistencyConstraint,
)
from .module import module
from .trajectory import Trajectory

__all__ = ["DirectTrajOptProblem", "get_trajectory_constraints"]


def get_trajectory_constraints(traj: Trajectory) -> list:
    """Pins and bounds from trajectory metadata. Bounds apply to the knots
    not covered by pins: both → 1..N-2, initial only → 1..N-1, final only →
    0..N-2, neither → all."""
    cons = []
    N = traj.N
    for name, val in traj.initial.items():
        cons.append(EqualityConstraint.create(name, [0], val, label=f"initial value of {name}"))
    for name, val in traj.final.items():
        cons.append(EqualityConstraint.create(name, [N - 1], val, label=f"final value of {name}"))
    for name, (lb, ub) in traj.bounds.items():
        if name in traj.global_names:
            cons.append(GlobalBoundsConstraint(lb=lb, ub=ub, name=name,
                                               label=f"bounds on global {name}"))
            continue
        if name in traj.initial and name in traj.final:
            ts = range(1, N - 1)
        elif name in traj.initial:
            ts = range(1, N)
        elif name in traj.final:
            ts = range(0, N - 1)
        else:
            ts = range(0, N)
        cons.append(BoundsConstraint(lb=lb, ub=ub, name=name, times=tuple(ts),
                                     subcomponents=None, label=f"bounds on {name}"))
    # time consistency + t_0 = 0 when both 't' and a free Δt are present
    if isinstance(traj.timestep, str) and "t" in traj.names:
        cons.append(TimeConsistencyConstraint(timestep_name=traj.timestep))
        if "t" not in traj.initial:
            ref = traj.data["t"]
            cons.append(EqualityConstraint.create(
                "t", [0], torch.zeros((traj.B, 1), dtype=ref.dtype, device=ref.device),
                label="initial time t_0 = 0"))
    return cons


@module
class DirectTrajOptProblem:
    """A direct trajectory optimization problem, one lane per scenario."""

    trajectory: Trajectory
    objective: object
    integrators: tuple
    constraints: tuple

    @staticmethod
    def create(traj: Trajectory, objective, integrators, *,
               constraints: Sequence = ()) -> "DirectTrajOptProblem":
        if not isinstance(integrators, (list, tuple)):
            integrators = (integrators,)
        ts = traj.timestep
        if isinstance(ts, str) and ts not in traj.bounds:
            warnings.warn(
                f"Trajectory has timestep variable {ts!r} but no bounds on it. "
                "Adding default lower bound of 0 to prevent negative timesteps.",
                stacklevel=2,
            )
            ref = traj.data[ts]
            shape = (traj.B, traj.dims[ts])
            new_bounds = dict(traj.bounds)
            new_bounds[ts] = (
                torch.zeros(shape, dtype=ref.dtype, device=ref.device),
                torch.full(shape, float("inf"), dtype=ref.dtype, device=ref.device),
            )
            traj = traj.replace(bounds=new_bounds)
        all_constraints = tuple(constraints) + tuple(get_trajectory_constraints(traj))
        return DirectTrajOptProblem(trajectory=traj, objective=objective,
                                    integrators=tuple(integrators),
                                    constraints=all_constraints)

    @property
    def N(self) -> int:
        return self.trajectory.N

    @property
    def B(self) -> int:
        return self.trajectory.B
