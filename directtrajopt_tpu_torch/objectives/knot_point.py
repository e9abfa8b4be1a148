"""User-defined knot-point objectives.

Counterpart of ``directtrajopt_tpu/objectives/knot_point.py``:
``KnotPointObjective`` is ``J = Σ_{k∈times} Q_k ℓ(vars_k[, p_k])`` with ℓ a
user scalar torch function of ONE knot's concatenated variables (no lane
axis; the port maps it over knots and lanes with ``torch.func.vmap``).
``TerminalObjective`` is the final-knot special case, and :func:`knot_hvp`
is the exact per-knot Hessian-vector product (forward over reverse).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from ..module import module
from ..trajectory import Layout, Trajectory
from .base import ObjectiveBase, lane_data
from .regularizers import times_mask

__all__ = ["KnotPointObjective", "TerminalObjective", "knot_hvp"]


@module
class KnotPointObjective(ObjectiveBase):
    """``Σ_k Q_k ℓ(vars_k, p_k)`` over selected knots."""

    Qs: torch.Tensor  # (B, N) weights, zero off the selected knots
    params: torch.Tensor | None  # (B, N, ...) per-knot parameters or None
    hvp_carrier: object | None  # declared KnotHVP capability (knot_hvp.py)
    ell: Callable
    var_names: tuple
    takes_params: bool = False

    @staticmethod
    def create(ell: Callable, names: str | Sequence[str], traj: Trajectory,
               params: Sequence | None = None, *, times: Sequence[int] | None = None,
               Qs: Sequence[float] | None = None, knot_hvp=None) -> "KnotPointObjective":
        names = (names,) if isinstance(names, str) else tuple(names)
        N, B = traj.N, traj.B
        ref = traj.data[names[0]]
        kw = dict(dtype=ref.dtype, device=ref.device)
        t_idx = np.arange(N) if times is None else np.asarray(times, dtype=int)
        q_full = np.zeros(N)
        q_full[t_idx] = np.ones(len(t_idx)) if Qs is None else np.asarray(Qs, dtype=float)
        q_full = q_full * times_mask(N, t_idx)
        params_full = None
        if params is not None:
            p_arr = np.stack([np.asarray(p, dtype=float) for p in params])
            full = np.zeros((N,) + p_arr.shape[1:])  # off-time rows carry zero weight
            full[t_idx] = p_arr
            params_full = torch.as_tensor(np.broadcast_to(full, (B,) + full.shape).copy(), **kw)
        return KnotPointObjective(
            Qs=torch.as_tensor(np.broadcast_to(q_full, (B, N)).copy(), **kw),
            params=params_full, hvp_carrier=knot_hvp, ell=ell, var_names=names,
            takes_params=params is not None,
        )

    def cost_at_knot(self, layout: Layout, zmat: torch.Tensor, g=None) -> torch.Tensor:
        vals = torch.cat([layout.knot_extract(zmat, n) for n in self.var_names], dim=-1)
        lead = vals.shape[:-1]
        flat = vals.reshape(-1, vals.shape[-1])
        if self.takes_params:
            p = lane_data(self.params, zmat).expand(lead + self.params.shape[2:])
            cost = vmap(self.ell)(flat, p.reshape((flat.shape[0],) + self.params.shape[2:]))
        else:
            cost = vmap(self.ell)(flat)
        return lane_data(self.Qs, zmat) * cost.reshape(lead)

    def __repr__(self):
        return f"KnotPointObjective on {list(self.var_names)}"


def TerminalObjective(ell: Callable, names: str | Sequence[str], traj: Trajectory, *,
                      Q: float = 1.0, params: Sequence | None = None) -> KnotPointObjective:
    """Objective applied at the final knot only."""
    return KnotPointObjective.create(ell, names, traj, params, times=[traj.N - 1], Qs=[Q])


def knot_hvp(obj, layout: Layout, zmat: torch.Tensor, v: torch.Tensor,
             gvec: torch.Tensor | None = None) -> torch.Tensor:
    """Per-knot Hessian-vector products ``∇²_{z_k} cost_k · v_k`` for every
    knot of every lane (``zmat``, ``v`` (B, ..., N, d); the global block
    ``gvec`` held fixed): forward over reverse through the knot costs, which
    are independent across knots."""
    g = grad(lambda z: obj.cost_at_knot(layout, z, gvec).sum())
    return jvp(g, (zmat,), (v,))[1]
