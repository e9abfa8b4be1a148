"""Constraint interface and canonical lowering target.

Counterpart of ``directtrajopt_tpu/constraints/base.py``. Every linear
constraint lowers into one canonical structure that the interior-point
method consumes directly: coordinate pins, box bounds, and affine equality
and inequality rows (``A Z = b`` and ``A Z ≤ b`` in COO form). Index arrays
are static numpy; pin, bound and right-hand-side values are ``(B, n)``
tensors, so the lanes of a batch may differ in them.

Row coefficients are the same for every lane. As in the JAX package, a
constraint that passes them as a numpy array marks them static, which the
Riccati backend's chain promotion requires; a constraint that passes a
tensor (``(nnz,)``, no lane axis) opts out of promotion.

Nonlinear constraints are residual functions with an ``equality`` flag
(``g = 0`` or ``g ≤ 0``), differentiated by ``torch.func``. Rows may reach
the global block, whose columns follow the knots' in flat Z.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..trajectory import Layout

__all__ = ["LinearCanon", "LinearConstraintBase", "NonlinearConstraintBase"]


@dataclass
class LinearCanon:
    """Accumulator for lowering linear constraints."""

    z_dim: int
    B: int = 1
    fix_idx: list = field(default_factory=list)  # np arrays of flat-Z indices
    fix_val: list = field(default_factory=list)  # (B, n) tensors
    lb_idx: list = field(default_factory=list)
    lb_val: list = field(default_factory=list)
    ub_idx: list = field(default_factory=list)
    ub_val: list = field(default_factory=list)
    # affine rows, COO per contribution: (rows, cols, vals, rhs, n_rows) with
    # rows/cols static numpy, vals numpy (static), an (nnz,) tensor or a per-lane
    # (B, nnz) one, rhs (B, n)
    eq_rows: list = field(default_factory=list)
    ineq_rows: list = field(default_factory=list)

    def pin(self, idx: np.ndarray, vals: torch.Tensor) -> None:
        self.fix_idx.append(np.asarray(idx, dtype=np.int64))
        self.fix_val.append(vals.reshape(vals.shape[0], -1))

    def bound(self, idx: np.ndarray, lb: torch.Tensor, ub: torch.Tensor) -> None:
        idx = np.asarray(idx, dtype=np.int64)
        self.lb_idx.append(idx)
        self.lb_val.append(lb.reshape(lb.shape[0], -1))
        self.ub_idx.append(idx)
        self.ub_val.append(ub.reshape(ub.shape[0], -1))

    def _rhs(self, rhs, n_rows: int) -> torch.Tensor:
        if isinstance(rhs, torch.Tensor):
            return rhs.reshape(rhs.shape[0], n_rows) if rhs.ndim > 1 else rhs.expand(self.B, n_rows)
        return torch.as_tensor(np.broadcast_to(np.asarray(rhs, dtype=np.float64).reshape(-1),
                                               (self.B, n_rows)).copy())

    @staticmethod
    def _vals(vals):
        """Static numpy values flat; a tensor's (nnz,) or, per lane, (B, nnz)."""
        if isinstance(vals, np.ndarray):
            return vals.astype(np.float64).reshape(-1)
        return vals if vals.ndim == 2 else vals.reshape(-1)

    def add_eq_rows(self, rows, cols, vals, rhs, n_rows: int) -> None:
        self.eq_rows.append((np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64),
                             self._vals(vals), self._rhs(rhs, n_rows), int(n_rows)))

    def add_ineq_rows(self, rows, cols, vals, rhs, n_rows: int) -> None:
        self.ineq_rows.append((np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64),
                               self._vals(vals), self._rhs(rhs, n_rows), int(n_rows)))


class LinearConstraintBase:
    """Linear constraints implement ``lower(layout, canon)``."""

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        raise NotImplementedError


class NonlinearConstraintBase:
    """Nonlinear constraints: residual functions with an equality flag.

    Subtypes provide ``constraint_dim(layout)`` and
    ``evaluate_flat(layout, zmat, g)`` (all residuals of all lanes at once),
    and the structured accessor the Riccati backend reads: a per-knot
    ``knot_residual(layout, z, p, g)`` (``uses_global`` true when it reads
    the global block g), or a pure-global ``global_residual(layout, g)``."""

    equality: bool = True
    uses_global: bool = False

    def constraint_dim(self, layout: Layout) -> int:
        raise NotImplementedError
