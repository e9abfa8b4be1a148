"""Objective interface and composition.

Counterpart of ``directtrajopt_tpu/objectives/base.py``. An objective is a
sum of per-knot costs plus a cost on the global block. Where the JAX
package defines the cost of one knot and ``vmap``s it, the port computes
all knots of all lanes at once:

    cost_at_knot(layout, zmat, g) -> (B, ..., N)   zmat (B, ..., N, dim), g (B, ..., global_dim)
    cost_global(layout, g)        -> (B, ...)

``uses_global`` says whether ``cost_at_knot`` reads g (the knot × global
cross terms of the Riccati backend's arrowhead). Extra axes between the
batch and the knot axis (the line search's trial grid) broadcast against
the objective's per-lane data. Gradients and the per-knot Hessian blocks
come from ``torch.func`` (see ``solvers/assembly.py`` and
``solvers/ops_riccati.py``).
"""

from __future__ import annotations

import torch
from torch.func import grad

from ..module import module
from ..trajectory import Layout

__all__ = ["ObjectiveBase", "CompositeObjective", "NullObjective", "objective_value",
           "objective_gradient", "objective_total", "lane_data"]


def lane_data(t: torch.Tensor, zmat: torch.Tensor) -> torch.Tensor:
    """View per-lane data ``t`` (B, ...) with singleton axes for the extra
    axes of ``zmat`` (B, *extra, N, dim), so the two broadcast."""
    extra = zmat.ndim - 3
    return t.reshape(t.shape[:1] + (1,) * extra + t.shape[1:])


class ObjectiveBase:
    """Mixin giving objectives ``+`` / ``*`` composition."""

    def cost_at_knot(self, layout: Layout, zmat: torch.Tensor, g=None) -> torch.Tensor:
        return torch.zeros(zmat.shape[:-1], dtype=zmat.dtype, device=zmat.device)

    def cost_global(self, layout: Layout, g: torch.Tensor) -> torch.Tensor:
        """Cost of the global block alone, ``(B, ...)`` for g (B, ..., global_dim)."""
        return g.new_zeros(g.shape[:-1])

    @property
    def uses_global(self) -> bool:
        """Whether ``cost_at_knot`` reads the global block."""
        return False

    def __add__(self, other):
        return _compose((self, other), (1.0, 1.0))

    def __radd__(self, other):
        if other == 0:
            return self
        return _compose((other, self), (1.0, 1.0))

    def __mul__(self, w):
        return _compose((self,), (float(w),))

    __rmul__ = __mul__


def _compose(objs, weights):
    out_objs, out_w = [], []
    for obj, w in zip(objs, weights):
        if isinstance(obj, CompositeObjective):
            for sub, sw in zip(obj.objectives, obj.weights):
                out_objs.append(sub)
                out_w.append(w * sw)
        else:
            out_objs.append(obj)
            out_w.append(w)
    return CompositeObjective(objectives=tuple(out_objs), weights=tuple(out_w))


@module
class CompositeObjective(ObjectiveBase):
    """Weighted sum ``Σ wᵢ Jᵢ`` with flattened nesting."""

    objectives: tuple
    weights: tuple

    def cost_at_knot(self, layout, zmat, g=None):
        total = torch.zeros(zmat.shape[:-1], dtype=zmat.dtype, device=zmat.device)
        for w, obj in zip(self.weights, self.objectives):
            total = total + w * obj.cost_at_knot(layout, zmat, g)
        return total

    def cost_global(self, layout, g):
        total = g.new_zeros(g.shape[:-1])
        for w, obj in zip(self.weights, self.objectives):
            total = total + w * obj.cost_global(layout, g)
        return total

    @property
    def uses_global(self) -> bool:
        return any(obj.uses_global for obj in self.objectives)

    def __repr__(self):
        terms = ", ".join(f"{w:g} * {obj!r}" for w, obj in zip(self.weights, self.objectives))
        return f"CompositeObjective({terms})"


@module
class NullObjective(ObjectiveBase):
    """The zero objective."""

    def __repr__(self):
        return "NullObjective"


def objective_total(obj: ObjectiveBase, layout: Layout, zmat: torch.Tensor,
                    g: torch.Tensor | None = None) -> torch.Tensor:
    """Total objective per lane (and per extra axis), ``(B, ...)``, from knot
    matrices ``zmat`` (B, ..., N, dim) and global blocks ``g``
    (B, ..., global_dim); the global cost enters only with a global block."""
    total = obj.cost_at_knot(layout, zmat, g).sum(-1)
    if layout.global_dim:
        total = total + obj.cost_global(layout, g)
    return total


def objective_value(obj: ObjectiveBase, traj) -> torch.Tensor:
    """Total objective of every lane of a trajectory, ``(B,)``."""
    return objective_total(obj, traj.layout, traj.knot_matrix(), traj.global_vec())


def objective_gradient(obj: ObjectiveBase, traj) -> torch.Tensor:
    """Gradient with respect to the flat decision vectors, ``(B, z_dim)``."""
    return grad(lambda z: objective_value(obj, traj.from_zvec(z)).sum())(traj.to_zvec())
