"""Objectives on global (time-invariant) variables.

Counterpart of ``directtrajopt_tpu/objectives/global_objectives.py``:

* ``GlobalObjective``: ``J = Q · ℓ(g_vars)`` on named global components;
* ``GlobalKnotPointObjective``: ``J = Σ_{k∈times} Q_k ℓ([vars_k; g_vars], p_k)``,
  coupling knot variables with the global block — its Hessian has the knot,
  global and knot × global blocks of the Riccati backend's arrowhead;
* ``GlobalTerminalObjective``: the final-knot special case.

ℓ is a user torch function of ONE vector (no lane axis), as for
``KnotPointObjective``; the port maps it over lanes (and knots, and the
line search's trial axes) with ``torch.func.vmap``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import vmap

from ..module import module
from ..trajectory import Layout, Trajectory
from .base import ObjectiveBase, lane_data
from .regularizers import times_mask

__all__ = ["GlobalObjective", "GlobalKnotPointObjective", "GlobalTerminalObjective"]


def _check_globals(names, traj: Trajectory) -> tuple:
    names = (names,) if isinstance(names, str) else tuple(names)
    for n in names:
        if n not in traj.global_names:
            raise ValueError(f"{n!r} is not a global component")
    return names


def _map(fn, vals: torch.Tensor, *extra) -> torch.Tensor:
    """``fn`` on every row of ``vals`` (..., k) (and of each ``extra``
    (..., ·)), by ``vmap`` over the flattened leading axes: (...)."""
    lead = vals.shape[:-1]
    flat = [vals.reshape(-1, vals.shape[-1])]
    flat += [e.reshape((flat[0].shape[0],) + e.shape[len(lead):]) for e in extra]
    return vmap(fn)(*flat).reshape(lead)


@module
class GlobalObjective(ObjectiveBase):
    """``Q · ℓ(globals)`` on named global components."""

    Q: torch.Tensor  # (B,)
    ell: Callable
    global_names: tuple

    @staticmethod
    def create(ell: Callable, names: str | Sequence[str], traj: Trajectory, *,
               Q: float = 1.0) -> "GlobalObjective":
        names = _check_globals(names, traj)
        ref = traj.global_data[names[0]]
        return GlobalObjective(Q=torch.full((traj.B,), float(Q), dtype=ref.dtype,
                                            device=ref.device),
                               ell=ell, global_names=names)

    def cost_global(self, layout: Layout, g: torch.Tensor) -> torch.Tensor:
        vals = layout.global_extract(g, self.global_names)
        Q = self.Q.reshape(self.Q.shape + (1,) * (g.ndim - 2))
        return Q * _map(self.ell, vals)

    def __repr__(self):
        return f"GlobalObjective on {list(self.global_names)}"


@module
class GlobalKnotPointObjective(ObjectiveBase):
    """``Σ_k Q_k ℓ([vars_k; globals], p_k)`` — knot × global coupling."""

    Qs: torch.Tensor  # (B, N) weights, zero off the selected knots
    params: torch.Tensor | None  # (B, N, ...) per-knot parameters or None
    ell: Callable
    var_names: tuple
    global_names: tuple
    takes_params: bool = False

    @staticmethod
    def create(ell: Callable, names: str | Sequence[str], global_names: str | Sequence[str],
               traj: Trajectory, params: Sequence | None = None, *,
               times: Sequence[int] | None = None,
               Qs: Sequence[float] | None = None) -> "GlobalKnotPointObjective":
        names = (names,) if isinstance(names, str) else tuple(names)
        global_names = _check_globals(global_names, traj)
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
            full = np.zeros((N,) + p_arr.shape[1:])
            full[t_idx] = p_arr
            params_full = torch.as_tensor(np.broadcast_to(full, (B,) + full.shape).copy(), **kw)
        return GlobalKnotPointObjective(
            Qs=torch.as_tensor(np.broadcast_to(q_full, (B, N)).copy(), **kw),
            params=params_full, ell=ell, var_names=names, global_names=global_names,
            takes_params=params is not None,
        )

    @property
    def uses_global(self) -> bool:
        return True

    def cost_at_knot(self, layout: Layout, zmat: torch.Tensor, g=None) -> torch.Tensor:
        knot = torch.cat([layout.knot_extract(zmat, n) for n in self.var_names], dim=-1)
        gv = layout.global_extract(g, self.global_names)
        vals = torch.cat([knot, gv[..., None, :].expand(knot.shape[:-1] + gv.shape[-1:])],
                         dim=-1)
        if self.takes_params:
            p = lane_data(self.params, zmat).expand(vals.shape[:-1] + self.params.shape[2:])
            cost = _map(self.ell, vals, p)
        else:
            cost = _map(self.ell, vals)
        return lane_data(self.Qs, zmat) * cost

    def __repr__(self):
        return (f"GlobalKnotPointObjective on {list(self.var_names)} + "
                f"{list(self.global_names)}")


def GlobalTerminalObjective(ell: Callable, names: str | Sequence[str],
                            global_names: str | Sequence[str], traj: Trajectory, *,
                            Q: float = 1.0,
                            params: Sequence | None = None) -> GlobalKnotPointObjective:
    """Knot + global objective at the final knot only."""
    return GlobalKnotPointObjective.create(ell, names, global_names, traj, params,
                                           times=[traj.N - 1], Qs=[Q])
