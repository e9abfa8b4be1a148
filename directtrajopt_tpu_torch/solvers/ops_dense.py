"""Dense KKT backend, and the inertia-regularization retry ladder shared by
the KKT backends.

Counterpart of ``directtrajopt_tpu/solvers/ops_dense.py``. The IPM consumes
derivatives through an operator interface:

    ctx = ops.prepare(Z, lam, nu)     # residuals and derivatives at Z
    ctx.c_e, ctx.c_i, ctx.grad_f      # residual vectors, objective gradient
    ctx.JeT(v), ctx.JiT(v), ctx.Ji(v) # Jacobian (transpose) products
    dZ, lam+, ok, delta, resolve = ctx.kkt_step(...)  # factor and solve with
                                      # the δ_w retry; ``resolve`` reuses
                                      # the factorization (SOC, restoration)

This backend assembles the full per-lane matrices (``solvers/assembly.py``)
and solves the condensed KKT system in augmented-Lagrangian form: the
Cholesky factorization of ``M = H + δ_w·I + JᵀJ/δ_c`` succeeding is the
correct-inertia certificate of the regularized KKT matrix (Haynsworth), and
M, as a preconditioner, solves the true (δ_c = 0) system by iterative
refinement. It is the general path, exact for every problem class and best
in float64; the Riccati backend (``ops_riccati.py``) is the structured one.

The batched factorization is ``torch.linalg.cholesky_ex``, which reports a
failed lane in ``info`` instead of raising; that lane's factor is replaced
by the identity and its certificate is false. The factorization and the
triangular solves are library calls, as in the JAX package, which computes
them outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from ..module import tree_where
from ..utils.profiling import span
from . import assembly
from .canonical import CanonicalNLP

__all__ = ["DenseOps"]


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
    with span("host.sync"):
        more = bool(go.any())
    while more:
        delta = carry[0]
        new_delta = torch.where(delta == 0.0, first_bump, delta * opt.delta_w_factor)
        new = (new_delta,) + tuple(factor(new_delta))
        carry = tree_where(go, new, carry)
        go = cond(carry)
        with span("host.sync"):
            more = bool(go.any())
    return carry


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-lane ``A @ v``: (B, m, n) × (B, n) → (B, m)."""
    return (A @ v.unsqueeze(-1)).squeeze(-1)


class _DenseCtx:
    def __init__(self, nlp: CanonicalNLP, Z, lam, nu, cache=None, gauss_newton=False,
                 skip_hessian=False):
        self.nlp = nlp
        self.Z = Z
        self.grad_f = assembly.gradient(nlp, Z)
        if cache is not None:
            # residuals at Z carried from the line search that accepted it
            self.c_e, self.c_i = cache
        else:
            self.c_e, self.c_i = nlp.c_eq(Z), nlp.c_in(Z)
        self._Je = assembly.jac_eq(nlp, Z)
        self._Ji = assembly.jac_in(nlp, Z)
        # quasi-Newton mode (L-BFGS): no second-order AD at all; the IPM
        # installs the model Hessian by set_hessian
        self._W = None if skip_hessian else assembly.hess_lagrangian(
            nlp, Z, lam, nu, 1.0, gauss_newton=gauss_newton)
        self._free = nlp.free_mask.to(Z.dtype)

    def set_hessian(self, W):
        """Install an external Lagrangian-Hessian model (B, z_dim, z_dim) (L-BFGS)."""
        self._W = W

    def JeT(self, v):
        return _mv(self._Je.transpose(-1, -2), v)

    def JiT(self, v):
        return _mv(self._Ji.transpose(-1, -2), v)

    def Ji(self, v):
        return _mv(self._Ji, v * self._free)

    def kkt_step(self, Sig, D, g_hat, rhs_c, delta_last, opt, active=None, refine=2):
        """Factor (with the δ_w retry) and solve. Returns
        ``(dZ, λ⁺, ok, δ, resolve)``; ``resolve(rhs_z, rhs_c)`` and
        ``resolve.many`` (a stacked (B, R, ·) variant) reuse the factors."""
        nlp = self.nlp
        f = self._free
        dtype, dev = g_hat.dtype, g_hat.device
        z_dim, n_eq = nlp.z_dim, nlp.n_eq
        # the δ_c floor scales with the working precision: in float32 a
        # δ_c of 1e-8 makes JᵀJ/δ_c swamp H; at √eps the augmented Cholesky
        # is a usable preconditioner and the refinement below (on the true
        # δ_c = 0 system) restores the accuracy
        eps = torch.finfo(dtype).eps
        delta_c = max(float(opt.delta_c), eps ** 0.5 * 0.1)
        eye = torch.eye(z_dim, dtype=dtype, device=dev)

        H = self._W + torch.diag_embed(Sig)
        if nlp.n_in:
            Jim = self._Ji * f
            H = H + (Jim.transpose(-1, -2) * D[:, None, :]) @ Jim
        Hbase = f[:, None] * f[None, :] * H + torch.diag(1.0 - f)
        del H
        Jm = self._Je * f if n_eq else self._Je
        JtJ = (Jm.transpose(-1, -2) @ Jm) / delta_c if n_eq else None
        fdiag = torch.diag(f)

        def factor(delta_w):
            M = Hbase + delta_w[:, None, None] * fdiag
            if n_eq:
                M = M + JtJ
            L, info = torch.linalg.cholesky_ex(M)
            ok = info == 0
            L = torch.where(ok[:, None, None], L, eye)
            return L, ok

        delta, L, ok = _reg_retry(factor, delta_last, opt, active)
        del JtJ
        Hm = Hbase + delta[:, None, None] * fdiag
        del Hbase

        def chol_solve(r):
            """Solve L Lᵀ x = r for R right-hand sides r (B, z_dim, R)."""
            return torch.cholesky_solve(r, L)

        JmT = Jm.transpose(-1, -2)

        def resolve_many(rhs_z_stack, rhs_c_stack):
            """R systems (B, R, ·) against the stored factors."""
            rz = rhs_z_stack.transpose(-1, -2)
            if n_eq == 0:
                dZ = chol_solve(rz)
                for _ in range(refine):
                    dZ = dZ + chol_solve(rz - Hm @ dZ)
                return dZ.transpose(-1, -2), rhs_z_stack.new_zeros(rhs_z_stack.shape[:2] + (0,))
            rc = rhs_c_stack.transpose(-1, -2)

            def aug(r_z, r_c):
                dz = chol_solve(r_z + JmT @ (r_c / delta_c))
                return dz, (Jm @ dz - r_c) / delta_c

            dZ, lam = aug(rz, rc)
            # refinement on the TRUE (δ_c = 0) system: the augmented solve
            # is only the preconditioner, so each pass contracts the error
            # by ~δ_c·‖S⁻¹‖ and both the δ_c perturbation and the float32
            # conditioning loss wash out
            for _ in range(refine):
                ddz, dlp = aug(rz - Hm @ dZ - JmT @ lam, rc - Jm @ dZ)
                dZ, lam = dZ + ddz, lam + dlp
            return dZ.transpose(-1, -2), lam.transpose(-1, -2)

        def resolve(rhs_z, rhs_c):
            dZ, lam = resolve_many(rhs_z[:, None], rhs_c[:, None])
            return dZ[:, 0], lam[:, 0]

        resolve.many = resolve_many

        dZ, lam_plus = resolve(-g_hat, rhs_c)
        ok = ok & torch.isfinite(dZ).all(-1) & torch.isfinite(lam_plus).all(-1)
        return dZ, lam_plus, ok, delta, resolve


class DenseOps:
    """Operator backend using the dense augmented-Lagrangian KKT solve."""

    def __init__(self, nlp: CanonicalNLP):
        self.nlp = nlp

    def prepare(self, Z, lam, nu, cache=None, gauss_newton=False, stagewise=False,
                skip_hessian=False) -> _DenseCtx:
        # ``stagewise`` (hessian_regularization) is a no-op here: the dense
        # path has no stage blocks to shift one by one, and a global
        # eigen-projection of W would cost a second factorization per
        # iteration. The δ_w ladder remains its inertia repair.
        return _DenseCtx(self.nlp, Z, lam, nu, cache, gauss_newton, skip_hessian)
