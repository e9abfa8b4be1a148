"""Matrix exponential: Taylor action and fixed-structure Padé.

Counterpart of ``directtrajopt_tpu/ops/expm.py``. ``expv_taylor`` is the
bilinear integrator's Taylor action; ``expm_pade`` (Padé-13 with a fixed
number of squarings) serves the integrator's Padé method and the rollouts
(``rollout.bilinear_rollout``); ``expm_apply`` is its action on a vector.
"""

from __future__ import annotations

import torch

__all__ = ["expv_taylor", "expm_pade", "expm_apply"]

# Padé-13 numerator coefficients (Higham 2005)
_B13 = (
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0, 1187353796428800.0,
    129060195264000.0, 10559470521600.0, 670442572800.0, 33522128640.0, 1323241920.0,
    40840800.0, 960960.0, 16380.0, 182.0, 1.0,
)


def expv_taylor(A: torch.Tensor, x: torch.Tensor, order: int = 12) -> torch.Tensor:
    """``exp(A) @ x`` by the Horner chain ``y ← x + A·y / k`` (k = order..1),
    batched over the leading axes of ``A`` (..., n, n) and ``x`` (..., n)."""
    y = x
    for k in range(order, 0, -1):
        y = x + (A @ y.unsqueeze(-1)).squeeze(-1) / k
    return y


def expm_pade(A: torch.Tensor, squarings: int = 4) -> torch.Tensor:
    """``exp(A)`` (..., n, n) via Padé-13 after scaling by ``2^-squarings``,
    then ``squarings`` squarings (exact to working precision while
    ``‖A‖ / 2^squarings ≲ 5``)."""
    A = A * (2.0 ** -squarings)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    b = _B13
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A4 @ A2
    U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2) + b[7] * A6 + b[5] * A4 + b[3] * A2
             + b[1] * eye)
    V = A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2) + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye
    R = torch.linalg.solve(V - U, V + U)
    for _ in range(squarings):
        R = R @ R
    return R


def expm_apply(A: torch.Tensor, x: torch.Tensor, squarings: int = 4) -> torch.Tensor:
    """``exp(A) @ x`` through :func:`expm_pade` (the JAX package's
    ``expm_apply``): ``A`` (..., n, n) and ``x`` (..., n) or (..., n, k)
    as ``@`` takes them."""
    return expm_pade(A, squarings=squarings) @ x
