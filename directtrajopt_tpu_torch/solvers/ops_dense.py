"""Inertia-regularization retry ladder shared by the KKT backends.

Counterpart of ``_reg_retry`` in ``directtrajopt_tpu/solvers/ops_dense.py``.
The dense KKT backend itself is not ported yet (ROADMAP Queue 1 item 11);
the Riccati backend uses this ladder.
"""

from __future__ import annotations

import torch

from ..module import tree_where

__all__ = ["_reg_retry"]


def _reg_retry(factor, delta_last, opt, active=None):
    """Per-lane δ_w retry: probe δ0, then raise δ until the factorization's
    inertia certificate holds or δ reaches ``delta_w_max``.

    ``factor(δ) -> (carry..., ok)`` on per-lane δ (B,). A lane whose
    certificate already holds keeps its factorization and its δ while other
    lanes retry — the semantics of the JAX package's ``while_loop`` under
    ``vmap``. ``active`` (B,) excludes lanes whose result the caller will
    discard from driving further retries. Returns ``(δ, carry..., ok)``.
    """
    zero = torch.zeros_like(delta_last)
    warm = torch.clamp(delta_last / opt.delta_w_decay, min=opt.delta_w_init)
    delta0 = torch.maximum(
        torch.as_tensor(opt.delta_w_min, dtype=delta_last.dtype, device=delta_last.device),
        torch.where(delta_last > 0, warm, zero),
    )
    carry = (delta0,) + tuple(factor(delta0))
    first_bump = torch.where(
        delta_last > 0, warm * opt.delta_w_factor,
        torch.full_like(delta_last, opt.delta_w_init * 100.0),
    )

    def cond(c):
        go = (~c[-1]) & (c[0] < opt.delta_w_max)
        return go if active is None else go & active

    go = cond(carry)
    while bool(go.any()):
        delta = carry[0]
        new_delta = torch.where(delta == 0.0, first_bump, delta * opt.delta_w_factor)
        new = (new_delta,) + tuple(factor(new_delta))
        carry = tree_where(go, new, carry)
        go = cond(carry)
    return carry
