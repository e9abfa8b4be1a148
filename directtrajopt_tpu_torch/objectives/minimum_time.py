"""Minimum-time objective: ``J = D Σ_{k<N-1} Δt_k``.

Counterpart of ``directtrajopt_tpu/objectives/minimum_time.py`` (the sum
runs over the first N−1 timesteps; requires a free timestep variable).
"""

from __future__ import annotations

import torch

from ..module import module
from ..trajectory import Layout, Trajectory
from .base import ObjectiveBase, lane_data

__all__ = ["MinimumTimeObjective"]


@module
class MinimumTimeObjective(ObjectiveBase):
    D: torch.Tensor  # (B,) weight per lane

    @staticmethod
    def create(traj: Trajectory, D: float = 1.0) -> "MinimumTimeObjective":
        if not isinstance(traj.timestep, str):
            raise ValueError("MinimumTimeObjective requires a free timestep variable")
        ref = traj.data[traj.timestep]
        return MinimumTimeObjective(D=torch.full((traj.B,), float(D), dtype=ref.dtype,
                                                 device=ref.device))

    def cost_at_knot(self, layout: Layout, zmat: torch.Tensor, g=None) -> torch.Tensor:
        dt = layout.knot_timestep(zmat)
        # the final knot's Δt is not part of the duration
        keep = torch.arange(layout.N, device=zmat.device) < layout.N - 1
        return torch.where(keep, lane_data(self.D, zmat)[..., None] * dt, 0.0)

    def __repr__(self):
        return "MinimumTimeObjective"
