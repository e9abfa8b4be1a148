"""Linear constraints: pins and box bounds.

Counterpart of the two classes of ``directtrajopt_tpu/constraints/linear.py``
that ``get_trajectory_constraints`` emits: :class:`EqualityConstraint`
(initial and final pins) and :class:`BoundsConstraint` (box bounds over a
range of knots). All time indices are 0-based. The rest of the JAX
package's linear constraint zoo is not ported yet (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..module import module
from ..trajectory import Layout
from .base import LinearCanon, LinearConstraintBase

__all__ = ["EqualityConstraint", "BoundsConstraint"]


def _z_indices(layout: Layout, name: str, times: Sequence[int], sub: slice | None = None):
    """Flat-Z indices of component ``name`` at the given knots (stacked)."""
    cs = layout.comp_slice(name)
    comp_idx = np.arange(cs.start, cs.stop)
    if sub is not None:
        comp_idx = comp_idx[sub]
    return np.concatenate([t * layout.dim + comp_idx for t in times]), len(comp_idx)


@module
class EqualityConstraint(LinearConstraintBase):
    """Pin a component to ``values`` (B, dim) at the given knots."""

    values: torch.Tensor
    name: str
    times: tuple
    label: str = "equality constraint"

    @staticmethod
    def create(name, times, values: torch.Tensor, *, label=None):
        times = tuple(int(t) for t in np.atleast_1d(times))
        return EqualityConstraint(
            values=values, name=name, times=times,
            label=label or f"equality constraint on {name}",
        )

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        idx, d = _z_indices(layout, self.name, self.times)
        vals = self.values.reshape(self.values.shape[0], -1)
        if vals.shape[1] == 1 and d > 1:
            vals = vals.expand(-1, d)
        if vals.shape[1] == d:
            tiled = vals.repeat(1, len(self.times))
        elif vals.shape[1] == d * len(self.times):
            tiled = vals
        else:
            raise ValueError(f"values shape {tuple(self.values.shape)} does not fit ({len(self.times)}, {d})")
        canon.pin(idx, tiled)


@module
class BoundsConstraint(LinearConstraintBase):
    """Box bounds ``lb ≤ v ≤ ub`` (each (B, n)) on a component over knots."""

    lb: torch.Tensor
    ub: torch.Tensor
    name: str
    times: tuple
    subcomponents: tuple | None = None
    label: str = "bounds constraint"

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        sub = slice(*self.subcomponents) if self.subcomponents else None
        idx, _ = _z_indices(layout, self.name, self.times, sub)
        T = len(self.times)
        canon.bound(idx, self.lb.repeat(1, T), self.ub.repeat(1, T))
