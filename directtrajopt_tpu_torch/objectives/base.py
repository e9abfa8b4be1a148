"""Objective interface and composition.

Counterpart of ``directtrajopt_tpu/objectives/base.py``. An objective is a
sum of per-knot costs. Where the JAX package defines the cost of one knot
and ``vmap``s it, the port computes all knots of all lanes at once:

    cost_at_knot(layout, zmat) -> (B, ..., N)   for zmat (B, ..., N, dim)

Extra axes between the batch and the knot axis (the line search's trial
grid) broadcast against the objective's per-lane data. Gradients and the
per-knot Hessian blocks come from ``torch.func`` (see
``solvers/assembly.py`` and ``solvers/ops_riccati.py``).
"""

from __future__ import annotations

import torch

from ..module import module
from ..trajectory import Layout

__all__ = ["ObjectiveBase", "CompositeObjective", "objective_value", "lane_data"]


def lane_data(t: torch.Tensor, zmat: torch.Tensor) -> torch.Tensor:
    """View per-lane data ``t`` (B, ...) with singleton axes for the extra
    axes of ``zmat`` (B, *extra, N, dim), so the two broadcast."""
    extra = zmat.ndim - 3
    return t.reshape(t.shape[:1] + (1,) * extra + t.shape[1:])


class ObjectiveBase:
    """Mixin giving objectives ``+`` / ``*`` composition."""

    def cost_at_knot(self, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
        return torch.zeros(zmat.shape[:-1], dtype=zmat.dtype, device=zmat.device)

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

    def cost_at_knot(self, layout, zmat):
        total = torch.zeros(zmat.shape[:-1], dtype=zmat.dtype, device=zmat.device)
        for w, obj in zip(self.weights, self.objectives):
            total = total + w * obj.cost_at_knot(layout, zmat)
        return total

    def __repr__(self):
        terms = ", ".join(f"{w:g} * {obj!r}" for w, obj in zip(self.weights, self.objectives))
        return f"CompositeObjective({terms})"


def objective_value(obj: ObjectiveBase, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
    """Total objective per lane (and per extra axis): ``(B, ...)``."""
    return obj.cost_at_knot(layout, zmat).sum(-1)
