"""Problem canonicalization: lower a problem into batched NLP callables.

Counterpart of ``directtrajopt_tpu/solvers/canonical.py``:

    min  f(Z)
    s.t. c_eq(Z) = 0      [dynamics ; affine rows A_eq Z − b_eq]
         c_in(Z) ≤ 0      [affine rows A_in Z − b_in]
         lb ≤ Z ≤ ub      (±inf where unbounded)
         Z[fix_idx] = fix_val   (pins, handled by projection)

Every callable takes ``Z`` of shape ``(B, ..., z_dim)`` — one row per lane,
with optional extra axes (the line search's trial grid) that broadcast
against the per-lane problem data — and returns ``(B, ..., ·)``.
Nonlinear constraints are not ported yet (ROADMAP Queue 1 item 9):
``make_nlp`` raises on them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constraints.base import LinearCanon, NonlinearConstraintBase
from ..integrators.base import stack_residuals, stack_residuals_l1
from ..objectives.base import lane_data, objective_value
from ..problem import DirectTrajOptProblem
from ..trajectory import Layout

__all__ = ["COORows", "CanonicalNLP", "make_nlp"]


@dataclass
class COORows:
    """Affine rows ``A Z`` in static-sparsity COO form; ``vals`` (B, nnz)."""

    rows: np.ndarray
    cols: np.ndarray
    vals: torch.Tensor
    n_rows: int
    n_cols: int

    def matvec(self, Z: torch.Tensor) -> torch.Tensor:
        out = Z.new_zeros(Z.shape[:-1] + (self.n_rows,))
        if len(self.rows) == 0:
            return out
        v = lane_data(self.vals, Z[..., None, :]) * Z[..., self.cols]
        return out.index_add(-1, torch.as_tensor(self.rows, device=Z.device), v)


@dataclass
class CanonicalNLP:
    """Batched NLP view of a problem."""

    layout: Layout
    z_dim: int
    n_dyn: int
    n_lin_eq: int
    n_lin_in: int
    fix_idx: np.ndarray  # static, unique
    fix_val: torch.Tensor  # (B, n_fix)
    free_mask: torch.Tensor  # (z_dim,) 1 where free, 0 where pinned
    pin_dense: torch.Tensor  # (B, z_dim) pin values, 0 where free
    lb: torch.Tensor  # (B, z_dim)
    ub: torch.Tensor
    A_eq: COORows
    b_eq: torch.Tensor
    A_in: COORows
    b_in: torch.Tensor
    integrators: tuple
    objective_obj: object
    eq_entries: tuple = ()
    in_entries: tuple = ()
    n_nl_eq: int = 0
    n_nl_in: int = 0

    @property
    def n_eq(self) -> int:
        return self.n_dyn + self.n_lin_eq + self.n_nl_eq

    @property
    def n_in(self) -> int:
        return self.n_lin_in + self.n_nl_in

    def _zmat(self, Z: torch.Tensor) -> torch.Tensor:
        L = self.layout
        return Z[..., : L.N * L.dim].reshape(Z.shape[:-1] + (L.N, L.dim))

    def objective(self, Z: torch.Tensor) -> torch.Tensor:
        return objective_value(self.objective_obj, self.layout, self._zmat(Z))

    def dynamics(self, Z: torch.Tensor) -> torch.Tensor:
        zmat = self._zmat(Z)
        parts = [
            stack_residuals(integ, self.layout, zmat).reshape(Z.shape[:-1] + (-1,))
            for integ in self.integrators
        ]
        return torch.cat(parts, dim=-1)

    def c_eq(self, Z: torch.Tensor) -> torch.Tensor:
        parts = [self.dynamics(Z)]
        if self.n_lin_eq:
            parts.append(self.A_eq.matvec(Z) - lane_data(self.b_eq, Z[..., None, :]))
        return torch.cat(parts, dim=-1)

    def c_eq_l1(self, Z: torch.Tensor) -> torch.Tensor:
        """``Σ|c_eq(Z)|`` without materializing the dynamics residuals
        (the bilinear integrator reduces inside its kernel)."""
        zmat = self._zmat(Z)
        tot = Z.new_zeros(Z.shape[:-1])
        for integ in self.integrators:
            tot = tot + stack_residuals_l1(integ, self.layout, zmat)
        if self.n_lin_eq:
            r = self.A_eq.matvec(Z) - lane_data(self.b_eq, Z[..., None, :])
            tot = tot + r.abs().sum(-1)
        return tot

    def c_in(self, Z: torch.Tensor) -> torch.Tensor:
        if self.n_lin_in:
            return self.A_in.matvec(Z) - lane_data(self.b_in, Z[..., None, :])
        return Z.new_zeros(Z.shape[:-1] + (0,))

    def apply_pins(self, Z: torch.Tensor) -> torch.Tensor:
        """Overwrite pinned coordinates with their fixed values."""
        if len(self.fix_idx) == 0:
            return Z
        return Z * self.free_mask + lane_data(self.pin_dense, Z[..., None, :])


def make_nlp(problem: DirectTrajOptProblem) -> CanonicalNLP:
    """Lower a problem to canonical NLP form."""
    traj = problem.trajectory
    layout = traj.layout
    z_dim = layout.z_dim
    B = traj.B
    ref = traj.data[traj.names[0]]
    kw = dict(dtype=ref.dtype, device=ref.device)

    canon = LinearCanon(z_dim=z_dim)
    for con in problem.constraints:
        if isinstance(con, NonlinearConstraintBase):
            raise NotImplementedError(
                "nonlinear constraints are not ported yet (ROADMAP Queue 1 item 9)"
            )
        con.lower(layout, canon)

    if canon.fix_idx:
        all_idx = np.concatenate(canon.fix_idx)
        uniq, inverse = np.unique(all_idx, return_inverse=True)
        fix_val = torch.zeros((B, len(uniq)), **kw)
        pos = 0
        for idx_arr, val_arr in zip(canon.fix_idx, canon.fix_val):
            n = len(idx_arr)  # later contributions override earlier ones
            fix_val[:, torch.as_tensor(inverse[pos : pos + n], device=ref.device)] = val_arr.to(**kw)
            pos += n
        fix_idx = uniq
    else:
        fix_idx = np.zeros((0,), dtype=np.int64)
        fix_val = torch.zeros((B, 0), **kw)
    fi = torch.as_tensor(fix_idx, device=ref.device)

    free_mask = torch.ones((z_dim,), **kw)
    free_mask[fi] = 0.0
    pin_dense = torch.zeros((B, z_dim), **kw)
    pin_dense[:, fi] = fix_val

    lb = torch.full((B, z_dim), -float("inf"), **kw)
    ub = torch.full((B, z_dim), float("inf"), **kw)
    for idx, val in zip(canon.lb_idx, canon.lb_val):
        ii = torch.as_tensor(idx, device=ref.device)
        lb[:, ii] = torch.maximum(lb[:, ii], val.to(**kw))
    for idx, val in zip(canon.ub_idx, canon.ub_val):
        ii = torch.as_tensor(idx, device=ref.device)
        ub[:, ii] = torch.minimum(ub[:, ii], val.to(**kw))
    lb[:, fi] = -float("inf")
    ub[:, fi] = float("inf")

    if canon.eq_rows or canon.ineq_rows:
        raise NotImplementedError(
            "affine constraint rows are not ported yet (ROADMAP Queue 1 item 9)"
        )
    empty = np.zeros(0, np.int64)
    no_rows = COORows(empty, empty, torch.zeros((B, 0), **kw), 0, z_dim)
    no_rhs = torch.zeros((B, 0), **kw)
    n_dyn = sum(i.residual_dim(layout) for i in problem.integrators) * (layout.N - 1)

    return CanonicalNLP(
        layout=layout, z_dim=z_dim, n_dyn=n_dyn, n_lin_eq=0, n_lin_in=0,
        fix_idx=fix_idx, fix_val=fix_val, free_mask=free_mask, pin_dense=pin_dense,
        lb=lb, ub=ub, A_eq=no_rows, b_eq=no_rhs, A_in=no_rows, b_in=no_rhs,
        integrators=tuple(problem.integrators), objective_obj=problem.objective,
    )
