"""Constraint interface and canonical lowering target.

Counterpart of ``directtrajopt_tpu/constraints/base.py``. Every linear
constraint lowers into one canonical structure that the interior-point
method consumes directly: coordinate pins, box bounds, and affine rows.
Index arrays are static numpy; value arrays are ``(B, n)`` tensors, so the
lanes of a batch may pin or bound to different values.
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
    fix_idx: list = field(default_factory=list)  # np arrays of flat-Z indices
    fix_val: list = field(default_factory=list)  # (B, n) tensors
    lb_idx: list = field(default_factory=list)
    lb_val: list = field(default_factory=list)
    ub_idx: list = field(default_factory=list)
    ub_val: list = field(default_factory=list)
    # affine rows, COO per contribution: (rows, cols, vals, rhs, n_rows)
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


class LinearConstraintBase:
    """Linear constraints implement ``lower(layout, canon)``."""

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        raise NotImplementedError


class NonlinearConstraintBase:
    """Nonlinear constraints (residual functions with an equality flag).

    None is ported yet: ``make_nlp`` raises on any instance (ROADMAP Queue 1
    item 9)."""

    equality: bool = True
