"""Matrix-exponential action by Taylor series.

Counterpart of ``expv_taylor`` in ``directtrajopt_tpu/ops/expm.py``. The
Padé ``expm_pade`` path is not ported yet (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import torch

__all__ = ["expv_taylor"]


def expv_taylor(A: torch.Tensor, x: torch.Tensor, order: int = 12) -> torch.Tensor:
    """``exp(A) @ x`` by the Horner chain ``y ← x + A·y / k`` (k = order..1),
    batched over the leading axes of ``A`` (..., n, n) and ``x`` (..., n)."""
    y = x
    for k in range(order, 0, -1):
        y = x + (A @ y.unsqueeze(-1)).squeeze(-1) / k
    return y
