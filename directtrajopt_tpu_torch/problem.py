"""Problem container: trajectory + objective + integrators + constraints.

Counterpart of ``directtrajopt_tpu/problem.py``: the constructor extracts
the trajectory constraints (initial / final pins, bounds over the knots the
pins leave free), and a free timestep with no bounds gets a default
``Δt ≥ 0`` lower bound with a warning.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import torch

from .constraints import BoundsConstraint, EqualityConstraint
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
    if isinstance(traj.timestep, str) and "t" in traj.names:
        raise NotImplementedError(
            "a 't' component with a free timestep needs TimeConsistencyConstraint, "
            "which is not ported yet (ROADMAP Queue 1 item 9)"
        )
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
