"""Quadratic regularizer.

Counterpart of ``QuadraticRegularizer`` in
``directtrajopt_tpu/objectives/regularizers.py``:
``J = Σ_k mask_k · ½ (Δt_k (v_k − b_k))ᵀ diag(R) (Δt_k (v_k − b_k))`` — the
Δt weighting creates v×Δt and Δt×Δt curvature when the timestep is free.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..module import module
from ..trajectory import Layout, Trajectory
from .base import ObjectiveBase, lane_data

__all__ = ["QuadraticRegularizer", "times_mask"]


def times_mask(N: int, times: Sequence[int] | None) -> np.ndarray:
    """(N,) 0/1 mask selecting the given knot indices (default: all)."""
    if times is None:
        return np.ones(N)
    mask = np.zeros(N)
    mask[np.asarray(times, dtype=int)] = 1.0
    return mask


@module
class QuadraticRegularizer(ObjectiveBase):
    """``Σ_k ½ ‖Δt_k (v_k − baseline_k)‖²_R`` on component ``name``."""

    R: torch.Tensor  # (B, dim) diagonal weights
    baseline: torch.Tensor  # (B, N, dim)
    mask: torch.Tensor  # (B, N) 0/1 times mask
    name: str

    @staticmethod
    def create(name: str, traj: Trajectory, R, *, baseline=None,
               times: Sequence[int] | None = None) -> "QuadraticRegularizer":
        dim, N, B = traj.dims[name], traj.N, traj.B
        ref = traj.data[name]
        kw = dict(dtype=ref.dtype, device=ref.device)
        R_vec = np.broadcast_to(np.asarray(R, dtype=float), (B, dim))
        base = np.zeros((B, N, dim)) if baseline is None else np.broadcast_to(
            np.asarray(baseline, dtype=float), (B, N, dim))
        mask = np.broadcast_to(times_mask(N, times), (B, N))
        return QuadraticRegularizer(
            R=torch.as_tensor(np.array(R_vec), **kw),
            baseline=torch.as_tensor(np.array(base), **kw),
            mask=torch.as_tensor(np.array(mask), **kw),
            name=name,
        )

    def cost_at_knot(self, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
        v = layout.knot_extract(zmat, self.name)
        dv = v - lane_data(self.baseline, zmat)
        dt = layout.knot_timestep(zmat)
        r = dt[..., None] * dv
        R = lane_data(self.R, zmat)[..., None, :]
        return lane_data(self.mask, zmat) * 0.5 * (r * (R * r)).sum(-1)

    def __repr__(self):
        return f"QuadraticRegularizer on {self.name}"
