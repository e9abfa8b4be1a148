"""Derivative assembly for the canonical NLP.

Counterpart of ``gradient`` in ``directtrajopt_tpu/solvers/assembly.py``.
The dense Jacobian and Hessian assembly of the JAX package's dense backend
is not ported yet (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import torch
from torch.func import grad

from .canonical import CanonicalNLP

__all__ = ["gradient"]


def gradient(nlp: CanonicalNLP, Z: torch.Tensor) -> torch.Tensor:
    """Objective gradient ∇f(Z) per lane, (B, z_dim). Lanes are independent,
    so the gradient of the summed objective is every lane's own gradient."""
    return grad(lambda z: nlp.objective(z).sum())(Z)
