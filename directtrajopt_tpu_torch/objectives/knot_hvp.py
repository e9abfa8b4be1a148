"""Declarable per-knot Hessian-vector-product capability carriers.

Counterpart of ``directtrajopt_tpu/objectives/knot_hvp.py``: an objective
may advertise a matrix-free per-knot Hessian apply —
``ConstantLowRankHVP(A, core)`` declares ``H = Aᵀ·core·A``,
``CustomKnotHVP`` wraps a user apply. Tensors carry the lane axis like every
other leaf of a problem; the generic fallback is
:func:`~.knot_point.knot_hvp`.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..module import module

__all__ = ["ConstantLowRankHVP", "CustomKnotHVP", "knot_hvp_of"]


@module
class ConstantLowRankHVP:
    """``H = Aᵀ G A`` per lane: A (B, r, dim), core G (B, r, r)."""

    A: torch.Tensor
    core: torch.Tensor

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """``H v`` for v (B, dim)."""
        w = torch.einsum("brd,bd->br", self.A, v)
        return torch.einsum("brd,br->bd", self.A, torch.einsum("brs,bs->br", self.core, w))

    def materialize(self) -> torch.Tensor:
        return self.A.transpose(-1, -2) @ self.core @ self.A


@module
class CustomKnotHVP:
    """User-supplied matrix-free apply; ``on_device`` advertises that the
    apply is plain tensor code that runs where its input lies."""

    apply_fn: Callable
    on_device: bool = True

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        return self.apply_fn(v)


def knot_hvp_of(objective):
    """The carrier an objective declares, or None."""
    return getattr(objective, "hvp_carrier", None)
