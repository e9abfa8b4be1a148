"""Structured derivative assembly for the canonical NLP.

Counterpart of ``directtrajopt_tpu/solvers/assembly.py``. Per-window and
per-knot derivative blocks come from ``torch.func`` (every window of every
lane at once) and are placed into dense per-lane matrices, the dense
backend's operands:

* equality rows ``[dynamics (per integrator, k-major) ; A_eq ; nonlinear eq]``
  — ``jac_eq`` (B, n_eq, z_dim);
* inequality rows ``[A_in ; nonlinear ineq]`` — ``jac_in`` (B, n_in, z_dim);
* the Lagrangian Hessian σ·(per-knot objective blocks + global arrowhead)
  + window blocks from the dynamics + knot blocks from the nonlinear
  constraints — ``hess_lagrangian`` (B, z_dim, z_dim).

Every placement writes each entry at most once per operation: a window's
Jacobian rows are its own, and the dynamics' window Hessians, which
overlap (window k's z_{k+1} block is window k+1's z_k block), are added
even windows first, then odd windows, each set through one strided view.
On the card no two additions race, so a float32 assembly is the same at
every call. The per-block helpers (objective knot and arrowhead Hessians,
nonlinear-constraint Jacobians and Hessians) also serve the Riccati
backend.
"""

from __future__ import annotations

import torch
from torch.func import grad, hessian, jacfwd, jvp, vmap

from ..integrators.base import stack_hessians, stack_jacobians
from .canonical import CanonicalNLP

__all__ = ["gradient", "jac_eq", "jac_in", "hess_lagrangian", "split_Z"]


def split_Z(nlp: CanonicalNLP, Z: torch.Tensor):
    """The knot matrices (B, N, dim) and global blocks (B, global_dim) of Z, views."""
    layout = nlp.layout
    zmat = Z[..., : layout.N * layout.dim].reshape(Z.shape[:-1] + (layout.N, layout.dim))
    return zmat, Z[..., layout.N * layout.dim :]


def gradient(nlp: CanonicalNLP, Z: torch.Tensor) -> torch.Tensor:
    """Objective gradient ∇f(Z) per lane, (B, z_dim). Lanes are independent,
    so the gradient of the summed objective is every lane's own gradient."""
    return grad(lambda z: nlp.objective(z).sum())(Z)


# ---------------- per-block derivatives ------------------------------------ #


def _knot_hessians(obj, layout, zmat: torch.Tensor, gvec=None) -> torch.Tensor:
    """Per-knot Hessians (B, N, d, d) of a knot-separable objective (the
    global block ``gvec`` held fixed), by forward-over-reverse AD: one
    tangent per coordinate, applied to every knot of every lane at once."""
    g = grad(lambda z: obj.cost_at_knot(layout, z, gvec).sum())
    eye = torch.eye(layout.dim, dtype=zmat.dtype, device=zmat.device)
    # out_dims=0: a Hessian that does not depend on the tangent (a linear
    # cost) comes back unbatched, which vmap cannot place on the last axis
    return vmap(lambda e: jvp(g, (zmat,), (e.expand_as(zmat),))[1])(eye).movedim(0, -1)


def _global_hessians(obj, layout, zmat: torch.Tensor, gvec: torch.Tensor):
    """The objective's arrowhead blocks: H_zg (B, N, d, n_g), each knot's
    ∂²cost_k/∂z_k∂g, and H_gg (B, n_g, n_g), ∂²/∂g² of the knot costs
    (when they read g) plus the global cost. Forward over reverse, one
    tangent per global coordinate applied to every lane at once."""

    def total(z, g):
        t = obj.cost_global(layout, g)
        if obj.uses_global:
            t = t + obj.cost_at_knot(layout, z, g).sum(-1)
        return t.sum()

    grads = grad(total, argnums=(0, 1))
    eye = torch.eye(gvec.shape[-1], dtype=gvec.dtype, device=gvec.device)

    def col(e):
        return jvp(lambda g: grads(zmat, g), (gvec,), (e.expand_as(gvec),))[1]

    Hz, Hg = vmap(col)(eye)
    return Hz.movedim(0, -1), Hg.movedim(0, -1)


def _coupled(con, layout) -> bool:
    """Whether a knot constraint reads the global block."""
    return bool(layout.global_dim) and getattr(con, "uses_global", False)


def _zsel(con, zmat):
    return zmat[:, list(con.times)]


def _gsel(con, gvec):
    # a copy: a forward-mode primal may not repeat a memory location
    return gvec[:, None, :].expand(gvec.shape[0], len(con.times), gvec.shape[-1]).contiguous()


def nl_jacobians(con, layout, zmat: torch.Tensor, gvec: torch.Tensor):
    """A nonlinear constraint's Jacobian blocks ``(jac_z, jac_g)``: jac_z
    (B, T, g_dim, d) per knot, None for a pure-global constraint; jac_g
    (B, T, g_dim, n_g) for a global-coupled knot constraint, (B, g_dim, n_g)
    for a pure-global one, None otherwise. torch.func's forward mode can
    promote the tangent of a 0-d float32 op with a Python float (u[0] − 0.1)
    to float64, so the blocks are cast back to the iterate's dtype."""
    dtype = zmat.dtype
    if not hasattr(con, "knot_residual"):
        return None, vmap(jacfwd(lambda g: con.global_residual(layout, g)))(gvec).to(dtype)
    if not _coupled(con, layout):
        jac = con.map_knots(
            lambda z, p: jacfwd(lambda zz: con.knot_residual(layout, zz, p))(z), _zsel(con, zmat))
        return jac.to(dtype), None
    zs, gs = _zsel(con, zmat), _gsel(con, gvec)
    jac = con.map_knots(
        lambda z, p, g: jacfwd(lambda zz: con.knot_residual(layout, zz, p, g))(z), zs, gs)
    jac_g = con.map_knots(
        lambda z, p, g: jacfwd(lambda gg: con.knot_residual(layout, z, p, gg))(g), zs, gs)
    return jac.to(dtype), jac_g.to(dtype)


def nl_hessians(con, layout, zmat: torch.Tensor, gvec: torch.Tensor, mu: torch.Tensor):
    """Blocks ``(H_zz, H_zg, H_gg)`` of ``Σ μ·g`` for one nonlinear
    constraint with multipliers ``mu`` (B, constraint_dim): H_zz
    (B, T, d, d) and H_zg (B, T, d, n_g) per knot, H_gg (B, n_g, n_g); None
    where the constraint has no such block."""
    d = layout.dim
    if not hasattr(con, "knot_residual"):
        Hgg = vmap(hessian(lambda g, m: (m * con.global_residual(layout, g)).sum()))(gvec, mu)
        return None, None, Hgg
    T = len(con.times)
    mu = mu.reshape(mu.shape[0], T, con.g_dim)
    if _coupled(con, layout):
        # one Hessian over [z_k; g] per knot, split into blocks
        def hess_w(z, p, m, g):
            def lagr(w):
                return (m * con.knot_residual(layout, w[:d], p, w[d:])).sum()

            return hessian(lagr)(torch.cat([z, g]))

        Hw = con.map_knots(hess_w, _zsel(con, zmat), mu, _gsel(con, gvec))
        return Hw[..., :d, :d], Hw[..., :d, d:], Hw[..., d:, d:].sum(1)

    def hess(z, p, m):
        return hessian(lambda zz: (m * con.knot_residual(layout, zz, p)).sum())(z)

    return con.map_knots(hess, _zsel(con, zmat), mu), None, None


# ---------------- dense placement ------------------------------------------ #


def _blocks_view(M: torch.Tensor, row0: int, row_step: int, col_step: int, K: int, r: int,
                 c: int, col0: int = 0) -> torch.Tensor:
    """The (B, K, r, c) strided view of a contiguous (B, R, C) tensor whose
    block k starts at row ``row0 + k·row_step``, column ``col0 + k·col_step``."""
    B, R, C = M.shape
    return M.as_strided((B, K, r, c), (R * C, row_step * C + col_step, C, 1),
                        M.storage_offset() + row0 * C + col0)


def _add_diag_blocks(H: torch.Tensor, blocks: torch.Tensor, step: int, row0: int = 0):
    """``H[b, row0 + k·step + i, row0 + k·step + j] += blocks[b, k, i, j]``,
    in place. Blocks wider than ``step`` overlap their neighbours: those are
    added in ``⌈width/step⌉`` passes over every that-many-th block, so each
    pass writes an entry at most once."""
    K, w = blocks.shape[1], blocks.shape[-1]
    n_pass = -(-w // step)
    for p in range(n_pass):
        sel = blocks[:, p::n_pass]
        if sel.shape[1]:
            _blocks_view(H, row0 + p * step, n_pass * step, n_pass * step, sel.shape[1], w, w,
                         row0 + p * step).add_(sel)
    return H


def jac_eq(nlp: CanonicalNLP, Z: torch.Tensor) -> torch.Tensor:
    """Dense equality-constraint Jacobian (B, n_eq, z_dim)."""
    layout = nlp.layout
    N, d = layout.N, layout.dim
    zmat, gvec = split_Z(nlp, Z)
    J = Z.new_zeros((Z.shape[0], nlp.n_eq, nlp.z_dim))
    off = 0
    for integ in nlp.integrators:
        r = integ.residual_dim(layout)
        blocks = stack_jacobians(integ, layout, zmat)  # (B, N-1, r, 2d)
        # window k: rows off + k·r .. + r, columns k·d .. k·d + 2d
        _blocks_view(J, off, r, d, N - 1, r, 2 * d).copy_(blocks)
        off += r * (N - 1)
    if nlp.n_lin_eq:
        J[:, off : off + nlp.n_lin_eq] = nlp.A_eq.dense(J.dtype)
        off += nlp.n_lin_eq
    return _add_nl_jacobian(nlp, J, zmat, gvec, nlp.eq_cons, off)


def jac_in(nlp: CanonicalNLP, Z: torch.Tensor) -> torch.Tensor:
    """Dense inequality-constraint Jacobian (B, n_in, z_dim)."""
    zmat, gvec = split_Z(nlp, Z)
    J = Z.new_zeros((Z.shape[0], nlp.n_in, nlp.z_dim))
    if nlp.n_lin_in:
        J[:, : nlp.n_lin_in] = nlp.A_in.dense(J.dtype)
    return _add_nl_jacobian(nlp, J, zmat, gvec, nlp.in_cons, nlp.n_lin_in)


def _add_nl_jacobian(nlp, J, zmat, gvec, cons, off):
    """Place the nonlinear constraints' Jacobian rows from row ``off``."""
    layout = nlp.layout
    d = layout.dim
    g_base = layout.N * d
    for con in cons:
        jac_z, jac_g = nl_jacobians(con, layout, zmat, gvec)
        gd = con.g_dim
        if jac_z is None:  # pure-global
            J[:, off : off + gd, g_base:] += jac_g
            off += gd
            continue
        for t, k in enumerate(con.times):
            rows = slice(off + t * gd, off + (t + 1) * gd)
            J[:, rows, k * d : (k + 1) * d] += jac_z[:, t]
            if jac_g is not None:
                J[:, rows, g_base:] += jac_g[:, t]
        off += len(con.times) * gd
    return J


def hess_lagrangian(nlp: CanonicalNLP, Z: torch.Tensor, lam: torch.Tensor, nu: torch.Tensor,
                    sigma: float = 1.0, gauss_newton: bool = False) -> torch.Tensor:
    """Dense Hessian of the Lagrangian σ∇²f + Σλᵢ∇²c_eq,i + Σνⱼ∇²c_in,j per
    lane, (B, z_dim, z_dim): per-knot objective blocks and the global
    arrowhead, per-window dynamics blocks, per-knot nonlinear-constraint
    blocks. ``gauss_newton`` keeps the objective curvature only."""
    layout = nlp.layout
    N, d, n_g = layout.N, layout.dim, layout.global_dim
    g_base = N * d
    zmat, gvec = split_Z(nlp, Z)
    B = Z.shape[0]
    H = Z.new_zeros((B, nlp.z_dim, nlp.z_dim))
    obj = nlp.objective_obj
    _add_diag_blocks(H, sigma * _knot_hessians(obj, layout, zmat, gvec), d)
    if n_g:
        Hzg, Hgg = _global_hessians(obj, layout, zmat, gvec)
        Hzg = sigma * Hzg.reshape(B, g_base, n_g)
        H[:, :g_base, g_base:] += Hzg
        H[:, g_base:, :g_base] += Hzg.transpose(-1, -2)
        H[:, g_base:, g_base:] += sigma * Hgg
    if gauss_newton:
        return H

    off = 0
    for integ in nlp.integrators:
        r = integ.residual_dim(layout)
        mu = lam[:, off : off + r * (N - 1)].reshape(B, N - 1, r)
        _add_diag_blocks(H, stack_hessians(integ, layout, zmat, mu), d)
        off += r * (N - 1)
    off += nlp.n_lin_eq  # affine rows: no curvature
    H = _add_nl_hessian(nlp, H, zmat, gvec, nlp.eq_cons, lam, off)
    return _add_nl_hessian(nlp, H, zmat, gvec, nlp.in_cons, nu, nlp.n_lin_in)


def _add_nl_hessian(nlp, H, zmat, gvec, cons, mults, off):
    """Add the nonlinear constraints' curvature, multipliers from ``off``."""
    layout = nlp.layout
    d = layout.dim
    g_base = layout.N * d
    for con in cons:
        n = con.constraint_dim(layout)
        Hzz, Hzg, Hgg = nl_hessians(con, layout, zmat, gvec, mults[:, off : off + n])
        if Hzz is not None:
            for t, k in enumerate(con.times):
                ks = slice(k * d, (k + 1) * d)
                H[:, ks, ks] += Hzz[:, t]
                if Hzg is not None:
                    H[:, ks, g_base:] += Hzg[:, t]
                    H[:, g_base:, ks] += Hzg[:, t].transpose(-1, -2)
        if Hgg is not None:
            H[:, g_base:, g_base:] += Hgg
        off += n
    return H
