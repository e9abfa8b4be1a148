"""Receding-horizon (MPC) utilities.

Counterpart of ``directtrajopt_tpu/utils/mpc.py``. Re-solving a solved
problem warm-starts from its trajectory; :func:`shift_trajectory` advances
the horizon (knot data shifted, the tail held) and sets the new measured
initial state, so solving the problem :func:`mpc_step` returns is one
warm-started MPC step. Every lane of a batch steps at once.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..problem import DirectTrajOptProblem
from ..trajectory import Trajectory

__all__ = ["shift_trajectory", "mpc_step"]


def shift_trajectory(traj: Trajectory, shift: int = 1,
                     new_initial: Mapping[str, object] | None = None) -> Trajectory:
    """Advance the horizon: knot k takes the data of knot k+shift (the last
    knot is held for the tail), and ``initial`` takes the measured values
    ((dim,) for every lane, or (B, dim)), which also become knot 0's data.
    The result is the warm start of the next MPC solve."""
    data = {name: torch.cat([arr[:, shift:], arr[:, -1:].expand(-1, shift, -1)], dim=1)
            for name, arr in traj.data.items()}
    initial = dict(traj.initial)
    for name, v in (new_initial or {}).items():
        arr = data[name]
        val = torch.as_tensor(v, dtype=arr.dtype, device=arr.device)
        initial[name] = val.reshape(-1, arr.shape[-1]).expand(arr.shape[0], -1).clone()
        data[name] = torch.cat([initial[name][:, None], arr[:, 1:]], dim=1)
    return traj.replace(data=data, initial=initial)


def mpc_step(problem: DirectTrajOptProblem, new_initial: Mapping[str, object],
             shift: int = 1) -> DirectTrajOptProblem:
    """One receding-horizon update: shift the (solved) trajectory and set the
    measured state; solve the returned problem to complete the MPC step."""
    return problem.replace(trajectory=shift_trajectory(problem.trajectory, shift, new_initial))
