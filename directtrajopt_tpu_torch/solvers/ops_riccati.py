"""Block-structured Riccati KKT backend.

Counterpart of ``directtrajopt_tpu/solvers/ops_riccati.py``. Knot variables
split into states (integrator targets) and inputs; the condensed KKT system
is a time-varying LQR solved by the fused Riccati factor+solve kernel
(``ops/riccati_kernel.py``), whose per-stage Cholesky is the inertia
certificate of the δ_w retry ladder. On top of that core:

* **chain promotion**: a static linear equality row
  ``β·z_{k+1}[c] + α·z_k = b`` covering every step (time consistency,
  (Δt-)all-equal) promotes coordinate c to a state; its rows join the core
  as affine "dynamics" rows normalized by β;
* **fast inequality rows**: knot-local inequality rows (linear or
  nonlinear) fold their D-scaled Gram ``Jᵀ D J`` into the per-knot Q blocks;
* **the border**: dynamics rows with a pinned target, linear equality rows
  that were not promoted (symmetry, totals), nonlinear equality rows, and
  multi-knot linear inequality rows (duration ranges) are a small border
  solved by a Schur complement over the factored core. Knot-local border
  rows get an augmented-Lagrangian curvature shift ρ·cᵀc on the owning
  knot; border inequalities carry the exact −1/D slack diagonal in place
  of −δ_c, rhs 0, and a discarded multiplier;
* **global variables** are an **arrowhead** border: n_g extra core solves
  against the −H_zg cross-Hessian columns ride the same fused sweep, then a
  2×2 block Schur solve over (λ_border, δg). The global block's Cholesky
  (of H_gg − H_zgᵀK⁻¹H_zg, with the border's W₁ᵀM⁻¹W₁) is part of the
  per-lane δ_w certificate, so with globals the border Schur factors are
  formed inside the retry. Global-coupled and pure-global nonlinear
  inequalities, and linear inequality rows with global columns, ride the
  border as border inequalities;
* **per-stage regularization** (``hessian_regularization``): "stagewise"
  (an estimated λ_min shift per stage) and "project" / "flip" / "floor"
  (per-stage spectral modification).

* **L-BFGS** (``hessian_approximation="lbfgs"``): ``prepare(...,
  skip_hessian=True)`` runs no second-order AD pass; :meth:`set_lbfgs`
  installs the compact model ``σI − UᵀM⁻¹U``, whose σ rides the free stage
  and global diagonals and whose low-rank part is a Sherman–Morrison–
  Woodbury correction after the factored solve (2m right-hand sides through
  one resolve sweep and a (2m)×(2m) dense solve per lane). ``resolve`` and
  ``resolve.many`` apply the same correction, so the SOC and the
  restoration see the corrected operator.

Not ported: the "floor" mode (ROADMAP Queue 1 item 3 records why).

All tensors carry a leading lane axis B.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..integrators.base import stack_hessians_zk, stack_jacobians_zk
from ..ops import riccati_kernel
from .assembly import _global_hessians, _knot_hessians, gradient, nl_hessians, nl_jacobians
from .canonical import CanonicalNLP, index_add_ordered
from .ops_dense import _reg_retry

__all__ = ["OCPStructure", "analyze", "RiccatiOps"]


def _chol(M: torch.Tensor) -> torch.Tensor:
    """Unrolled Crout Cholesky of the tiny border Schur matrix (..., n, n);
    NaN entries where it fails (the JAX package's ``_chol``)."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    inv = [None] * n
    for i in range(n):
        for j in range(i + 1):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(s)
                inv[i] = 1.0 / L[i][j]
            else:
                L[i][j] = s * inv[j]
    zero = torch.zeros_like(M[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
            for i in range(n)]
    return torch.stack(rows, dim=-2)


def _chosolve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(L Lᵀ)⁻¹ b`` for vectors b (..., n) or matrices b (..., n, m),
    unrolled (``_chosolve``)."""
    n = L.shape[-1]
    vec = b.ndim == L.ndim - 1
    rows = [b[..., i] for i in range(n)] if vec else [b[..., i, :] for i in range(n)]

    def lij(i, k):
        return L[..., i, k] if vec else L[..., i, k][..., None]

    inv = [1.0 / L[..., i, i] for i in range(n)]
    y = [None] * n
    for i in range(n):
        s = rows[i]
        for k in range(i):
            s = s - lij(i, k) * y[k]
        y[i] = s * inv[i] if vec else s * inv[i][..., None]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - lij(k, i) * x[k]
        x[i] = s * inv[i] if vec else s * inv[i][..., None]
    return torch.stack(x, dim=-1 if vec else -2)


def _stage_min_shift(Q: torch.Tensor, n_iter: int = 12, margin_rel: float = 1e-5):
    """Per-stage Levenberg shift ``max(0, −λ̂_min(Q_k) + ε_k)`` (…, N) from a
    shifted power iteration on ``cI − Q`` (c: the Gershgorin bound), as the
    JAX package's ``_stage_min_shift``. An estimate, not a certificate: the
    Cholesky inertia check and the δ_w ladder stay the backstop."""
    d = Q.shape[-1]
    c = torch.clamp(Q.abs().sum(-1).amax(-1), min=1e-30)
    v0 = np.sign(np.sin(1.0 + np.arange(d))) / np.sqrt(float(d))
    v = torch.as_tensor(v0, dtype=Q.dtype, device=Q.device).expand(Q.shape[:-2] + (d,))
    for _ in range(n_iter):
        w = c[..., None] * v - torch.einsum("...ij,...j->...i", Q, v)
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-30)
    ray = torch.einsum("...i,...ij,...j->...", v, Q, v)
    return torch.clamp(-ray + margin_rel * c, min=0.0)


def _stage_project(Q: torch.Tensor, mode: str, eps_rel: float = 1e-6) -> torch.Tensor:
    """Per-stage spectral modification of the stage blocks (B, N, d, d):
    "project" λ → max(λ, ε), "flip" λ → max(|λ|, ε), "floor" λ → max(λ, ε)
    where λ > −ε and λ unchanged elsewhere, with ε = eps_rel · max |λ| over
    the lane's stages (``_stage_project``)."""
    Qs = 0.5 * (Q + Q.transpose(-1, -2))
    lam, V = torch.linalg.eigh(Qs)
    eps = eps_rel * torch.clamp(lam.abs().amax((-2, -1)), min=1e-30)
    eps = eps.reshape(eps.shape + (1, 1))
    if mode == "floor":
        lam_m = torch.where(lam > -eps, torch.maximum(lam, eps), lam)
    else:
        lam_m = torch.maximum(lam.abs() if mode == "flip" else lam, eps)
    return torch.einsum("...ij,...j,...kj->...ik", V, lam_m, V)


@dataclass
class OCPStructure:
    """Static structure of an explicit OCP."""

    N: int
    d: int
    s_idx: np.ndarray  # (n_s,) state component indices within a knot
    v_idx: np.ndarray  # (n_v,) input component indices
    s_pos: list  # per-integrator (offset, r) into the s-order
    free_blk: np.ndarray  # (N, d) 0/1: 0 where pinned
    core_mask: np.ndarray  # (N-1, n_s) 1 for rows kept in the Riccati core
    bp_steps: np.ndarray  # (n_bp,) step index of border-pinned dynamics rows
    bp_rows: np.ndarray  # (n_bp,) s-order row index of those rows
    bp_flat: np.ndarray  # (n_bp,) flat c_eq indices of those rows
    dyn_flat_of_stack: np.ndarray  # (N-1, n_s) flat c_eq index of each core slot
    s0_mask: np.ndarray  # (n_s,) 1 where s_0 is free to optimize
    # chain promotion: trailing s-order slots whose "dynamics" rows are
    # linear equality rows β·z_{k+1}[c] + α·z_k = b, normalized by β
    promo_jr: np.ndarray  # (N-1, n_promo, d) normalized Jacobians α/β
    core_beta: np.ndarray  # (N-1, n_s) β per core row (1 for real dynamics)
    lin_border_rows: np.ndarray  # A_eq row indices not promoted (border)
    n_g: int  # global-variable count (the arrowhead's width)
    g_free: np.ndarray  # (n_g,) 1 where the global coordinate is free
    # inequality row → (knot, slot) maps (fast rows; border rows masked out)
    in_knot: np.ndarray  # (n_in,)
    in_slot: np.ndarray  # (n_in,)
    m_in: int
    lin_in_nnz: tuple  # (knot, slot, col_local) of the fast linear COO entries
    # border inequalities (multi-knot or global-coupled rows): the flat c_in
    # index of each, in border order (linear rows, then the nonlinear border
    # constraints in constraint order), and the A_in rows of the linear ones
    ib_flat: np.ndarray  # (n_ib,)
    ib_lin_rows: np.ndarray  # (n_ib_lin,)
    in_fast_mask: np.ndarray  # (n_in,) 1.0 on fast rows
    lin_nnz_keep: np.ndarray  # (nnz,) per-COO-entry fast-row mask
    nl_eq_offsets: list  # flat c_eq offset of each nonlinear equality
    nl_in_offsets: list  # flat c_in offset of each nonlinear inequality


def _in_con_border(con) -> bool:
    """True when a nonlinear inequality rides the Schur border (global-coupled
    or pure-global) instead of the per-knot fast path."""
    return not hasattr(con, "knot_residual") or getattr(con, "uses_global", False)


def analyze(nlp: CanonicalNLP) -> OCPStructure | None:
    """Check Riccati eligibility and build the static structure."""
    layout = nlp.layout
    N, d = layout.N, layout.dim
    n_g = layout.global_dim
    if not nlp.integrators:
        return None
    s_list, s_pos = [], []
    for integ in nlp.integrators:
        if not getattr(integ, "explicit", False):
            return None
        cs = layout.comp_slice(integ.x_name)
        s_pos.append((len(s_list), cs.stop - cs.start))
        s_list.extend(range(cs.start, cs.stop))
    if len(set(s_list)) != len(s_list):
        return None  # overlapping targets

    # ---- chain promotion: static rows β·z_{k+1}[c] + α·z_k = b covering
    # every step k = 0..N-2 for one coordinate c promote c to a state
    taken = set(s_list)
    chains: dict[int, dict] = {}  # coord c -> {step k: (A_eq row, β, α/β)}
    flat_off = 0
    for rows, cols, vals, _, n in nlp.eq_entries:
        if isinstance(vals, np.ndarray) and len(cols) and not np.any(cols >= N * d):
            for r in range(n):
                sel = rows == r
                cs, vs = cols[sel], vals[sel]
                if not len(cs):
                    continue
                kt = int(np.max(cs) // d)
                tgt = cs // d == kt
                if kt < 1 or np.sum(tgt) != 1 or not np.all(cs[~tgt] // d == kt - 1):
                    continue
                c = int(cs[tgt][0] % d)
                beta = float(vs[tgt][0])
                if c in taken or beta == 0.0:
                    continue
                jr = np.zeros(d)
                jr[cs[~tgt] % d] = vs[~tgt] / beta
                chains.setdefault(c, {})[kt - 1] = (flat_off + r, beta, jr)
        flat_off += n
    n_lin_rows = flat_off
    promo_cols = sorted(c for c, steps in chains.items() if len(steps) == N - 1)
    n_promo = len(promo_cols)
    promo_flat = np.zeros((N - 1, n_promo), dtype=np.int64)
    promo_beta = np.ones((N - 1, n_promo))
    promo_jr = np.zeros((N - 1, n_promo, d))
    promoted_rows: set[int] = set()
    for j, c in enumerate(promo_cols):
        taken.add(c)
        for k in range(N - 1):
            fr, beta, jr = chains[c][k]
            promo_flat[k, j] = fr
            promo_beta[k, j] = beta
            promo_jr[k, j] = jr
            promoted_rows.add(fr)
    lin_border_rows = np.asarray([r for r in range(n_lin_rows) if r not in promoted_rows],
                                 dtype=np.int64)

    s_idx = np.asarray(s_list + promo_cols, dtype=np.int64)
    v_idx = np.asarray([i for i in range(d) if i not in taken], dtype=np.int64)
    n_s = len(s_idx)

    # nonlinear constraints: knot-local (optionally global-coupled) or pure
    # global; global coupling goes through the arrowhead border
    for con in nlp.eq_cons + nlp.in_cons:
        if not (hasattr(con, "knot_residual") or hasattr(con, "global_residual")):
            return None

    # linear inequality rows: knot-local, global-free → fast path;
    # multi-knot or global-coupled → border
    ib_lin_rows = []
    row_off0 = 0
    for rows, cols, _, _, n in nlp.in_entries:
        knots = cols // d
        for r in range(n):
            sel = rows == r
            if np.any(sel) and (np.any(cols[sel] >= N * d)
                                or not np.all(knots[sel] == knots[sel][0])):
                ib_lin_rows.append(row_off0 + r)
        row_off0 += n
    ib_lin_set = set(ib_lin_rows)

    free = np.ones(N * d + n_g)
    free[nlp.fix_idx] = 0.0
    free_blk = free[: N * d].reshape(N, d)
    g_free = free[N * d :].copy()
    # dynamics rows whose target coordinate is pinned go to the border; pins
    # of global coordinates (indices ≥ N·d) are g_free's
    target_flat = (np.arange(1, N)[:, None] * d) + s_idx[None, :]
    pinned = np.zeros(N * d, dtype=bool)
    pinned[nlp.fix_idx[nlp.fix_idx < N * d]] = True
    bp = pinned[target_flat]
    core_mask = (~bp).astype(np.float64)
    bp_steps, bp_rows = np.nonzero(bp)

    # flat c_eq index of each (step, s-order row): per-integrator k-major,
    # then the promoted chains (their rows live in the A_eq range of c_eq)
    dyn_flat = np.zeros((N - 1, n_s), dtype=np.int64)
    off = 0
    for pos, r in s_pos:
        for k in range(N - 1):
            dyn_flat[k, pos : pos + r] = off + k * r + np.arange(r)
        off += r * (N - 1)
    core_beta = np.ones((N - 1, n_s))
    if n_promo:
        dyn_flat[:, n_s - n_promo :] = nlp.n_dyn + promo_flat
        core_beta[:, n_s - n_promo :] = promo_beta

    # inequality row maps (border rows keep dummy 0/0 slots, masked out of
    # every fast-path gather/scatter by in_fast_mask)
    n_in = nlp.n_in
    in_knot = np.zeros(n_in, dtype=np.int64)
    in_slot = np.zeros(n_in, dtype=np.int64)
    in_fast_mask = np.ones(n_in)
    per_knot_count = np.zeros(N, dtype=np.int64)
    row_off = 0
    lin_nnz_knot, lin_nnz_slot, lin_nnz_col, lin_nnz_keep = [], [], [], []
    lin_row_slot = {}
    for rows, cols, _, _, n in nlp.in_entries:
        for r in range(n):
            if row_off + r in ib_lin_set:
                in_fast_mask[row_off + r] = 0.0
                continue
            sel = rows == r
            kr = int((cols[sel] // d)[0]) if np.any(sel) else 0
            in_knot[row_off + r] = kr
            in_slot[row_off + r] = per_knot_count[kr]
            lin_row_slot[row_off + r] = (kr, per_knot_count[kr])
            per_knot_count[kr] += 1
        for rr, cc in zip(rows, cols):
            if row_off + rr in ib_lin_set:
                lin_nnz_keep.append(False)
                continue
            lin_nnz_keep.append(True)
            kr, sl = lin_row_slot[row_off + rr]
            lin_nnz_knot.append(kr)
            lin_nnz_slot.append(sl)
            lin_nnz_col.append(cc % d)
        row_off += n
    nl_in_offsets, ib_nl_flat = [], []
    for con in nlp.in_cons:
        nl_in_offsets.append(row_off)
        if _in_con_border(con):
            n_rows = con.constraint_dim(layout)
            ib_nl_flat.extend(range(row_off, row_off + n_rows))
            in_fast_mask[row_off : row_off + n_rows] = 0.0
            row_off += n_rows
            continue
        for t in con.times:
            for _ in range(con.g_dim):
                in_knot[row_off] = t
                in_slot[row_off] = per_knot_count[t]
                per_knot_count[t] += 1
                row_off += 1
    m_in = int(per_knot_count.max()) if n_in else 0

    nl_eq_offsets = []
    off = nlp.n_dyn + nlp.n_lin_eq
    for con in nlp.eq_cons:
        nl_eq_offsets.append(off)
        off += con.constraint_dim(layout)

    return OCPStructure(
        N=N, d=d, s_idx=s_idx, v_idx=v_idx, s_pos=s_pos, free_blk=free_blk,
        core_mask=core_mask, bp_steps=bp_steps, bp_rows=bp_rows,
        bp_flat=dyn_flat[bp_steps, bp_rows], dyn_flat_of_stack=dyn_flat,
        s0_mask=free_blk[0, s_idx].copy(), promo_jr=promo_jr, core_beta=core_beta,
        lin_border_rows=lin_border_rows, n_g=n_g, g_free=g_free, in_knot=in_knot,
        in_slot=in_slot, m_in=m_in,
        lin_in_nnz=(np.asarray(lin_nnz_knot, dtype=np.int64),
                    np.asarray(lin_nnz_slot, dtype=np.int64),
                    np.asarray(lin_nnz_col, dtype=np.int64)),
        ib_flat=np.asarray(ib_lin_rows + ib_nl_flat, dtype=np.int64),
        ib_lin_rows=np.asarray(ib_lin_rows, dtype=np.int64), in_fast_mask=in_fast_mask,
        lin_nnz_keep=np.asarray(lin_nnz_keep, dtype=bool),
        nl_eq_offsets=nl_eq_offsets, nl_in_offsets=nl_in_offsets,
    )


def _lane_scatter_add(base: torch.Tensor, idx: list, vals: torch.Tensor) -> torch.Tensor:
    """``base[b, *idx] += vals[b]`` for every lane b (duplicates accumulate);
    the index tensors share one shape and address the axes after the lane."""
    lane = torch.arange(base.shape[0], device=base.device)
    lane = lane.reshape((-1,) + (1,) * idx[0].ndim)
    return base.index_put((lane, *(i[None] for i in idx)), vals, accumulate=True)


class _RiccatiCtx:
    def __init__(self, nlp: CanonicalNLP, S: OCPStructure, Z, lam, nu, cache=None,
                 gauss_newton: bool = False, stagewise=False, skip_hessian: bool = False):
        self.nlp = nlp
        self._lbfgs = None
        self.S = S
        layout = nlp.layout
        N, d, n_g = S.N, S.d, S.n_g
        B = Z.shape[0]
        dtype, dev = Z.dtype, Z.device
        self.dtype = dtype
        # the knots and the global block, views of Z
        zmat = Z[:, : N * d].reshape(B, N, d)
        gvec = Z[:, N * d :]
        self.grad_f = gradient(nlp, Z)
        if cache is not None:
            # residuals at Z carried over from the line search that accepted it
            self.c_e, self.c_i = cache
        else:
            self.c_e, self.c_i = nlp.c_eq(Z), nlp.c_in(Z)

        # dynamics Jacobians w.r.t. z_k in s-order (B, N-1, n_s, d); promoted
        # chains contribute their static normalized rows α/β
        jr = [stack_jacobians_zk(integ, layout, zmat) for integ in nlp.integrators]
        if S.promo_jr.shape[1]:
            jr.append(torch.as_tensor(S.promo_jr, dtype=dtype, device=dev).expand(
                (B,) + S.promo_jr.shape))
        self.Jr = torch.cat(jr, dim=2)
        # core rows are normalized (original row = β · core row)
        self.core_beta = torch.as_tensor(S.core_beta, dtype=dtype, device=dev)
        self.core_beta_inv = torch.as_tensor(1.0 / S.core_beta, dtype=dtype, device=dev)
        lin_mask = np.zeros(nlp.n_lin_eq)
        lin_mask[S.lin_border_rows] = 1.0
        self._lin_mask = torch.as_tensor(lin_mask, dtype=dtype, device=dev)

        eq_j = [nl_jacobians(c, layout, zmat, gvec) for c in nlp.eq_cons]
        in_j = [nl_jacobians(c, layout, zmat, gvec) for c in nlp.in_cons]
        self.nl_eq_jacs = [j for j, _ in eq_j]
        self.nl_in_jacs = [j for j, _ in in_j]
        self.nl_eq_jacs_g = [jg for _, jg in eq_j]
        self.nl_in_jacs_g = [jg for _, jg in in_j]

        # Lagrangian Hessian blocks (B, N, d, d): objective, then (exact
        # Hessian only) the λ-weighted dynamics and the λ/ν-weighted
        # nonlinear-constraint curvature; with globals, the arrowhead blocks
        # H_zg (B, N, d, n_g) and H_gg (B, n_g, n_g) from the same terms
        obj = nlp.objective_obj
        if skip_hessian:
            # L-BFGS: no AD Hessian at all; the model arrives by set_lbfgs
            # (σ on the diagonals, the cross curvature in the low-rank part)
            gauss_newton = True
            QW = torch.zeros((B, N, d, d), dtype=dtype, device=dev)
            if n_g:
                Hzg = torch.zeros((B, N, d, n_g), dtype=dtype, device=dev)
                Hgg = torch.zeros((B, n_g, n_g), dtype=dtype, device=dev)
        else:
            QW = _knot_hessians(obj, layout, zmat, gvec)
            if n_g:
                Hzg, Hgg = _global_hessians(obj, layout, zmat, gvec)
        if not gauss_newton:
            off = 0
            for integ, (_, r) in zip(nlp.integrators, S.s_pos):
                mu = lam[:, off : off + r * (N - 1)].reshape(B, N - 1, r)
                blocks = stack_hessians_zk(integ, layout, zmat, mu)
                QW = torch.cat([QW[:, : N - 1] + blocks, QW[:, N - 1 :]], dim=1)
                off += r * (N - 1)
            for cons, offsets, mults in ((nlp.eq_cons, S.nl_eq_offsets, lam),
                                         (nlp.in_cons, S.nl_in_offsets, nu)):
                for con, o in zip(cons, offsets):
                    n = con.constraint_dim(layout)
                    Hzz, Hzg_c, Hgg_c = nl_hessians(con, layout, zmat, gvec, mults[:, o : o + n])
                    tt = None if Hzz is None else torch.as_tensor(con.times, device=dev)
                    if Hzz is not None:
                        QW = QW.index_add(1, tt, Hzz)
                    if Hzg_c is not None:
                        Hzg = Hzg.index_add(1, tt, Hzg_c)
                    if Hgg_c is not None:
                        Hgg = Hgg + Hgg_c
        self.QW = QW
        if n_g:
            self.Hzg, self.Hgg = Hzg, Hgg
        # "stagewise" | "project" | "flip" or False (Gauss-Newton is PSD)
        self.stagewise = False if gauss_newton else stagewise

        f_blk = torch.as_tensor(S.free_blk, dtype=dtype, device=dev)
        self.f_blk = f_blk
        self._dyn = torch.as_tensor(S.dyn_flat_of_stack.reshape(-1), device=dev)
        self._s_ix = torch.as_tensor(S.s_idx, device=dev)
        self._v_ix = torch.as_tensor(S.v_idx, device=dev)
        self._in_knot = torch.as_tensor(S.in_knot, device=dev)
        self._in_slot = torch.as_tensor(S.in_slot, device=dev)
        self._fast = torch.as_tensor(S.in_fast_mask, dtype=dtype, device=dev)
        self._ib = torch.as_tensor(S.ib_flat, device=dev)

        # per-knot fast inequality Jacobian blocks (B, N, m_in, d)
        Jin = torch.zeros((B, N, S.m_in, d), dtype=dtype, device=dev)
        if nlp.n_in and S.m_in:
            kz, sz, cz = S.lin_in_nnz
            if len(kz):
                vals = nlp.A_in.vals[:, torch.as_tensor(np.nonzero(S.lin_nnz_keep)[0], device=dev)]
                Jin = _lane_scatter_add(Jin, [torch.as_tensor(a, device=dev) for a in (kz, sz, cz)],
                                        vals)
            row = nlp.n_lin_in
            for con, jac in zip(nlp.in_cons, self.nl_in_jacs):
                if _in_con_border(con):
                    row += con.constraint_dim(layout)
                    continue
                T, gd = len(con.times), con.g_dim
                kn = torch.as_tensor(S.in_knot[row : row + T * gd].reshape(T, gd), device=dev)
                sl = torch.as_tensor(S.in_slot[row : row + T * gd].reshape(T, gd), device=dev)
                Jin = _lane_scatter_add(Jin, [kn, sl], jac)
                row += T * gd
        self.Jin_raw = Jin
        self.Jin = Jin * f_blk[:, None, :]

        # border-inequality Jacobians, raw (unmasked), in border order: the
        # knot part (B, n_ib, N, d) and the global columns (B, n_ib, n_g)
        n_ib = len(S.ib_flat)
        self.n_ib = n_ib
        n_ibl = len(S.ib_lin_rows)
        Jib_z = torch.zeros((B, n_ib, N, d), dtype=dtype, device=dev)
        Jib_g = torch.zeros((B, n_ib, n_g), dtype=dtype, device=dev)
        if n_ibl:
            rows = nlp.A_in.select_rows(S.ib_lin_rows)
            Jib_z[:, :n_ibl] = rows[..., : N * d].reshape(B, n_ibl, N, d)
            Jib_g[:, :n_ibl] = rows[..., N * d :]
        pos = n_ibl
        for con, jac, jac_g in zip(nlp.in_cons, self.nl_in_jacs, self.nl_in_jacs_g):
            if not _in_con_border(con):
                continue
            gd = con.g_dim
            if hasattr(con, "knot_residual"):
                T = len(con.times)
                ri = torch.arange(pos, pos + T * gd, device=dev).reshape(T, gd)
                tt = torch.as_tensor(con.times, device=dev)[:, None].expand(T, gd)
                Jib_z[:, ri, tt, :] = jac
                if jac_g is not None:
                    Jib_g[:, pos : pos + T * gd] = jac_g.reshape(B, T * gd, n_g)
                pos += T * gd
            else:
                Jib_g[:, pos : pos + gd] = jac_g
                pos += gd
        self.Jib_z, self.Jib_g = Jib_z, Jib_g

    # ---------------- matvecs ---------------------------------------------- #

    def JeT(self, v: torch.Tensor) -> torch.Tensor:
        """``J_eqᵀ v`` per lane: (B, n_eq) → (B, z_dim)."""
        nlp, S = self.nlp, self.S
        N, d, n_s, n_g = S.N, S.d, len(S.s_idx), S.n_g
        B = v.shape[0]
        # promoted-chain slots hold the normalized row: Jᵀv = J_normᵀ(β∘v)
        vd = v[:, self._dyn].reshape(B, N - 1, n_s) * self.core_beta
        out = torch.zeros((B, N, d), dtype=v.dtype, device=v.device)
        out[:, : N - 1] += torch.einsum("bkrd,bkr->bkd", self.Jr, vd)
        out[:, 1:, self._s_ix] += vd
        out_g = v.new_zeros((B, n_g)) if n_g else None
        for con, jac, jac_g, o in zip(nlp.eq_cons, self.nl_eq_jacs, self.nl_eq_jacs_g,
                                      S.nl_eq_offsets):
            if jac is None:  # pure-global
                out_g = out_g + torch.einsum("bgn,bg->bn", jac_g, v[:, o : o + con.g_dim])
                continue
            T, gd = len(con.times), con.g_dim
            vr = v[:, o : o + T * gd].reshape(B, T, gd)
            contr = torch.einsum("btgd,btg->btd", jac, vr)
            out = out.index_add(1, torch.as_tensor(con.times, device=v.device), contr)
            if jac_g is not None:
                out_g = out_g + torch.einsum("btgn,btg->bn", jac_g, vr)
        full = out.reshape(B, -1)
        if n_g:
            full = torch.cat([full, out_g], dim=1)
        if nlp.n_lin_eq:
            # promoted rows were consumed above: mask them out of A_eqᵀ
            full = full + nlp.A_eq.rmatvec(v[:, nlp.n_dyn : nlp.n_dyn + nlp.n_lin_eq]
                                           * self._lin_mask)
        return full

    def JiT(self, v: torch.Tensor) -> torch.Tensor:
        """``J_inᵀ v`` per lane: (B, n_in) → (B, z_dim)."""
        S = self.S
        B = v.shape[0]
        out = torch.zeros((B, S.N, S.d), dtype=v.dtype, device=v.device)
        out_g = v.new_zeros((B, S.n_g)) if S.n_g else None
        if self.nlp.n_in:
            if S.m_in:
                vb = _lane_scatter_add(
                    torch.zeros((B, S.N, S.m_in), dtype=v.dtype, device=v.device),
                    [self._in_knot, self._in_slot], v * self._fast)
                out = torch.einsum("bnmd,bnm->bnd", self.Jin_raw, vb)
            if self.n_ib:
                v_ib = v[:, self._ib]
                out = out + torch.einsum("bjnd,bj->bnd", self.Jib_z, v_ib)
                if S.n_g:
                    out_g = out_g + torch.einsum("bjn,bj->bn", self.Jib_g, v_ib)
        full = out.reshape(B, -1)
        return torch.cat([full, out_g], dim=1) if S.n_g else full

    def Ji(self, v: torch.Tensor) -> torch.Tensor:
        """``J_in v`` per lane on the free coordinates: (B, z_dim) → (B, n_in)."""
        nlp, S = self.nlp, self.S
        B = v.shape[0]
        if nlp.n_in == 0:
            return v.new_zeros((B, 0))
        vfull = v * nlp.free_mask
        vm = vfull[:, : S.N * S.d].reshape(B, S.N, S.d)
        if S.m_in:
            prod = torch.einsum("bnmd,bnd->bnm", self.Jin, vm)
            out = prod[:, self._in_knot, self._in_slot]
        else:
            out = v.new_zeros((B, nlp.n_in))
        if self.n_ib:
            out = out * self._fast
            ib_vals = torch.einsum("bjnd,bnd->bj", self.Jib_z, vm)
            if S.n_g:
                ib_vals = ib_vals + torch.einsum("bjn,bn->bj", self.Jib_g, vfull[:, S.N * S.d :])
            out = out.index_copy(1, self._ib, ib_vals)
        return out

    # ---------------- KKT solve -------------------------------------------- #

    def set_lbfgs(self, sigma, U, M):
        """Install the compact L-BFGS model ``B = σI − Uᵀ M⁻¹ U`` per lane
        (σ (B,), U (B, 2m, z_dim), M (B, 2m, 2m); ``ipm._lbfgs_compact``):
        kkt_step adds σ to the free stage and global diagonals and applies the
        low-rank term by SMW through the factored solve."""
        self._lbfgs = (sigma, U * self.nlp.free_mask, M)

    def kkt_step(self, Sig, D, g_hat, rhs_c, delta_last, opt, active=None):
        nlp, S = self.nlp, self.S
        N, d, n_g = S.N, S.d, S.n_g
        n_s = len(S.s_idx)
        B = Sig.shape[0]
        dtype, dev = self.dtype, Sig.device
        f_blk = self.f_blk
        s_ix, v_ix = self._s_ix, self._v_ix

        # ---- condensed per-knot Hessian blocks: pins → identity rows ----- #
        Q = self.QW * f_blk[:, :, None] * f_blk[:, None, :]
        Q = Q + torch.diag_embed(1.0 - f_blk)
        Q = Q + torch.diag_embed(Sig[:, : N * d].reshape(B, N, d))
        if self._lbfgs is not None:
            # the L-BFGS base model σI on the free stage diagonal (the
            # low-rank −UᵀM⁻¹U part is applied by SMW after the solve)
            Q = Q + torch.diag_embed(self._lbfgs[0][:, None, None] * f_blk)
        if nlp.n_in and S.m_in:
            # fast inequality rows: the D-scaled Gram JᵀDJ per knot
            Db = _lane_scatter_add(torch.zeros((B, N, S.m_in), dtype=dtype, device=dev),
                                   [self._in_knot, self._in_slot], D * self._fast)
            Q = Q + torch.einsum("bnmd,bnm,bnme->bnde", self.Jin, Db, self.Jin)

        # ---- arrowhead blocks (masked; the δ-independent parts) ----------- #
        if n_g:
            gf = torch.as_tensor(S.g_free, dtype=dtype, device=dev)
            Hzg_m = self.Hzg * f_blk[:, :, None] * gf
            Hgg_m = (self.Hgg * gf[:, None] * gf + torch.diag(1.0 - gf)
                     + torch.diag_embed(Sig[:, N * d :] * gf))
            if self._lbfgs is not None:
                Hgg_m = Hgg_m + torch.diag_embed(self._lbfgs[0][:, None] * gf)

        # ---- dynamics blocks ---------------------------------------------- #
        Jr_m = self.Jr * f_blk[: N - 1, None, :]
        cm = torch.as_tensor(S.core_mask, dtype=dtype, device=dev)
        A_full = -Jr_m * cm[:, :, None]
        zpad_s = torch.zeros((B, 1, n_s, n_s), dtype=dtype, device=dev)
        zpad_v = torch.zeros((B, 1, n_s, len(S.v_idx)), dtype=dtype, device=dev)
        Abar_p = torch.cat([A_full[..., s_ix], zpad_s], dim=1)
        Bbar_p = torch.cat([A_full[..., v_ix], zpad_v], dim=1)
        binv = self.core_beta_inv

        # ---- border rows: [pinned-target dynamics ; linear equalities not
        # promoted ; nonlinear equalities ; border inequalities], each with a
        # knot part C and, with globals, a global-column part Cg. Knot-local
        # global-free rows get the ρ curvature shift; global-coupled rows are
        # certified through the arrowhead's Schur block instead ------------ #
        n_bp = len(S.bp_steps)
        n_lb = len(S.lin_border_rows)
        n_ib = self.n_ib
        bp_steps = torch.as_tensor(S.bp_steps, device=dev)
        bp_binv = torch.as_tensor(S.core_beta[S.bp_steps, S.bp_rows] ** -1.0, dtype=dtype,
                                  device=dev)
        C_rows, Cg_rows = [], []
        loc_knots, loc_flat, loc_scale, loc_vecs, loc_mask = [], [], [], [], []
        if n_bp:
            C_bp = torch.zeros((B, n_bp, N, d), dtype=dtype, device=dev)
            C_bp[:, torch.arange(n_bp, device=dev), bp_steps, :] = \
                Jr_m[:, bp_steps, torch.as_tensor(S.bp_rows, device=dev), :]
            C_rows.append(C_bp)
            if n_g:
                Cg_rows.append(torch.zeros((B, n_bp, n_g), dtype=dtype, device=dev))
            loc_knots.append(S.bp_steps)
            loc_flat.append(S.bp_flat)
            loc_scale.append(S.core_beta[S.bp_steps, S.bp_rows] ** -1.0)
            loc_vecs.append(C_bp)
            loc_mask.append(np.ones(n_bp))
        if n_lb:
            A_lb = nlp.A_eq.select_rows(S.lin_border_rows) * nlp.free_mask
            C_rows.append(A_lb[..., : N * d].reshape(B, n_lb, N, d))
            if n_g:
                Cg_rows.append(A_lb[..., N * d :])
            loc_mask.append(np.zeros(n_lb))
        for con, jac, jac_g, o in zip(nlp.eq_cons, self.nl_eq_jacs, self.nl_eq_jacs_g,
                                      S.nl_eq_offsets):
            if jac is None:  # pure-global: no knot part
                C_rows.append(torch.zeros((B, con.g_dim, N, d), dtype=dtype, device=dev))
                Cg_rows.append(jac_g * gf)
                loc_mask.append(np.zeros(con.g_dim))
                continue
            times = np.asarray(con.times)
            T, gd = len(times), con.g_dim
            Cc = torch.zeros((B, T, gd, N, d), dtype=dtype, device=dev)
            tt = torch.as_tensor(times, device=dev)
            Cc[:, torch.arange(T, device=dev), :, tt, :] = (jac * f_blk[tt][None, :, None, :]
                                                          ).transpose(0, 1)
            Cc = Cc.reshape(B, T * gd, N, d)
            C_rows.append(Cc)
            if jac_g is None:
                if n_g:
                    Cg_rows.append(torch.zeros((B, T * gd, n_g), dtype=dtype, device=dev))
                loc_knots.append(np.repeat(times, gd))
                loc_flat.append(np.arange(o, o + T * gd))
                loc_scale.append(np.ones(T * gd))
                loc_vecs.append(Cc)
                loc_mask.append(np.ones(T * gd))
            else:
                Cg_rows.append((jac_g * gf).reshape(B, T * gd, n_g))
                loc_mask.append(np.zeros(T * gd))
        if n_ib:
            C_rows.append(self.Jib_z * f_blk)
            if n_g:
                Cg_rows.append(self.Jib_g * gf)
            loc_mask.append(np.zeros(n_ib))
            e_ib = 1.0 / torch.clamp(D[:, self._ib], min=1e-30)
        m_c = sum(c.shape[1] for c in C_rows)
        C = torch.cat(C_rows, dim=1) if m_c else torch.zeros((B, 0, N, d), dtype=dtype, device=dev)
        Cg = None
        if n_g:
            Cg = torch.cat(Cg_rows, dim=1) if m_c else torch.zeros((B, 0, n_g), dtype=dtype,
                                                                 device=dev)
        # per-row (2,2) diagonal: δ_c on equality rows, the exact 1/D on
        # inequality rows (refine_e keeps it in the refinement residual)
        delta_c = torch.full((B, m_c - n_ib), opt.delta_c, dtype=dtype, device=dev)
        diag_e = torch.cat([delta_c, e_ib], dim=1) if n_ib else delta_c
        refine_e = torch.cat([torch.zeros_like(delta_c), e_ib], dim=1) if n_ib else None
        loc_border_mask = torch.as_tensor(np.concatenate(loc_mask) if loc_mask else np.zeros(0),
                                          dtype=dtype, device=dev)

        # ---- augmented-Lagrangian curvature shift ρ·cᵀc on the owning knot
        # of knot-local border rows (pins of state coordinates, nonlinear
        # equalities): the constrained solution is unchanged, and the stage
        # Cholesky certificate then matches the full KKT inertia ---------- #
        rho = opt.border_penalty
        if loc_knots:
            lk_np = np.concatenate(loc_knots)
            lk = torch.as_tensor(lk_np, device=dev)
            lf = torch.as_tensor(np.concatenate(loc_flat), device=dev)
            ls = torch.as_tensor(np.concatenate(loc_scale), dtype=dtype, device=dev)
            lv = torch.cat(loc_vecs, dim=1)[:, torch.arange(len(lk_np), device=dev), lk, :]
            Q = index_add_ordered(Q, 1, lk_np, rho * lv[:, :, None, :] * lv[:, :, :, None])
        else:
            lv = None

        sw_shift = None
        if self.stagewise in ("project", "flip", "floor"):
            # spectral modification of the full stage blocks, once, before
            # the (s, v) sub-blocks are sliced
            Q = _stage_project(Q, self.stagewise)
        elif self.stagewise:
            sw_shift = _stage_min_shift(Q)

        Qss = Q[:, :, s_ix][:, :, :, s_ix]
        Qsv = Q[:, :, s_ix][:, :, :, v_ix]
        Qvv = Q[:, :, v_ix][:, :, :, v_ix]
        fS = torch.diag_embed(f_blk[:, s_ix])
        fV = torch.diag_embed(f_blk[:, v_ix])

        def rho_adjust(rhs_z_blk, rhs_c_flat):
            """Rhs shift matching the ρ·cᵀc in Q; (L, N, d), (L, n_eq) with
            L a multiple of B (lane-major repeats)."""
            if lv is None:
                return rhs_z_blk
            rep = rhs_z_blk.shape[0] // B
            lv_r = lv.repeat_interleave(rep, 0) if rep > 1 else lv
            r_loc = rhs_c_flat[:, lf] * ls
            # the shifts of one knot are summed before they meet the rhs
            return rhs_z_blk + index_add_ordered(torch.zeros_like(rhs_z_blk), 1, lk_np,
                                                 rho * lv_r * r_loc[:, :, None])

        def b_dyn_pad(rhs_c_flat):
            L = rhs_c_flat.shape[0]
            b_dyn = rhs_c_flat[:, self._dyn].reshape(L, N - 1, n_s) * binv * cm
            return torch.cat([b_dyn, torch.zeros((L, 1, n_s), dtype=dtype, device=dev)], dim=1)

        def border_rhs(rhs_c_flat):
            L = rhs_c_flat.shape[0]
            parts = []
            if n_bp:
                parts.append(rhs_c_flat[:, torch.as_tensor(S.bp_flat, device=dev)] * bp_binv)
            if n_lb:
                parts.append(rhs_c_flat[:, nlp.n_dyn + torch.as_tensor(S.lin_border_rows,
                                                                       device=dev)])
            for con, o in zip(nlp.eq_cons, S.nl_eq_offsets):
                parts.append(rhs_c_flat[:, o : o + con.constraint_dim(nlp.layout)])
            if n_ib:  # border inequalities carry rhs 0
                parts.append(rhs_c_flat.new_zeros((L, n_ib)))
            return torch.cat(parts, dim=1) if parts else rhs_c_flat.new_zeros((L, 0))

        def scatter_dz(dzs_, dzv_):
            out = torch.zeros(dzs_.shape[:-1] + (d,), dtype=dtype, device=dev)
            out[..., s_ix] = dzs_
            out[..., v_ix] = dzv_
            return out

        def pack_lam(lam_stack, lam_c):
            """Flat λ (L, n_eq); core rows are normalized, so λ = λ_norm/β.
            The border inequalities' multipliers are discarded."""
            L = lam_stack.shape[0]
            lam_flat = torch.zeros((L, nlp.n_eq), dtype=dtype, device=dev)
            lam_flat[:, self._dyn] = (lam_stack * binv).reshape(L, -1)
            pos = 0
            if n_bp:
                lam_flat[:, torch.as_tensor(S.bp_flat, device=dev)] = lam_c[:, :n_bp] * bp_binv
                pos = n_bp
            if n_lb:
                lam_flat[:, nlp.n_dyn + torch.as_tensor(S.lin_border_rows, device=dev)] = \
                    lam_c[:, pos : pos + n_lb]
                pos += n_lb
            for con, o in zip(nlp.eq_cons, S.nl_eq_offsets):
                cd = con.constraint_dim(nlp.layout)
                lam_flat[:, o : o + cd] = lam_c[:, pos : pos + cd]
                pos += cd
            return lam_flat

        # right-hand sides of the fused sweep: m_c border columns (−C, zero
        # dynamics rhs), n_g arrowhead columns (−H_zg, zero dynamics rhs),
        # then the main system
        rhs_main = rho_adjust((-g_hat[:, : N * d]).reshape(B, N, d), rhs_c)
        cols = [-C]
        if n_g:
            cols.append(-Hzg_m.permute(0, 3, 1, 2))
        q_all = torch.cat(cols + [-rhs_main[:, None]], dim=1)  # (B, m_c+n_g+1, N, d)
        b_all = torch.cat(
            [torch.zeros((B, m_c + n_g, N, n_s), dtype=dtype, device=dev),
             b_dyn_pad(rhs_c)[:, None]],
            dim=1,
        )
        qs_all = q_all[..., s_ix]
        qv_all = q_all[..., v_ix]
        s0m = S.s0_mask

        def chol_or_eye(M):
            """Cholesky factor and its per-lane certificate; a failed lane
            gets the identity."""
            Lc = _chol(M)
            fin = torch.isfinite(Lc)
            return (torch.where(fin, Lc, torch.eye(M.shape[-1], dtype=dtype, device=dev)),
                    fin.all(-1).all(-1))

        if n_g:
            diag_gf = torch.diag(gf)

        def factor(delta):
            dsh = delta[:, None] if sw_shift is None else delta[:, None] + sw_shift
            dsh = dsh.expand(B, N)[:, :, None, None]
            P, Lv, Kg, Mvs, L0, okf, dzs, dzv, lamS = riccati_kernel.factor_solve(
                s0m, Qss + dsh * fS, Qsv, Qvv + dsh * fV, Abar_p, Bbar_p,
                qs_all, qv_all, b_all,
            )
            if not n_g:
                return P, Lv, Kg, Mvs, L0, dzs, dzv, lamS, None, None, okf
            # the arrowhead's Schur block inside the retry: δ_w certifies the
            # stage factors, the border's Schur block M and the reduced global
            # Hessian T = H_gg' − H_zgᵀK⁻¹H_zg (+ W₁ᵀM⁻¹W₁) together
            dz_ = scatter_dz(dzs, dzv)
            Y_ = dz_[:, m_c : m_c + n_g]
            HzgTY = torch.einsum("bndg,bjnd->bgj", Hzg_m, Y_)
            Tm = (Hgg_m + delta[:, None, None] * diag_gf
                  - 0.5 * (HzgTY + HzgTY.transpose(-1, -2)))
            if m_c:
                Ls_, ok_s = chol_or_eye(torch.einsum("bjnd,bknd->bjk", C, dz_[:, :m_c])
                                        + torch.diag_embed(diag_e))
                W1_ = torch.einsum("bjnd,bind->bji", C, Y_) - Cg
                Tm = Tm + W1_.transpose(-1, -2) @ _chosolve(Ls_, W1_)
            else:
                Ls_ = W1_ = None
                ok_s = okf
            Lg_, ok_g = chol_or_eye(Tm)
            return P, Lv, Kg, Mvs, L0, dzs, dzv, lamS, (Ls_, W1_), Lg_, okf & ok_s & ok_g

        (delta, P_all, Lv_all, Kg_all, Mvs_all, L0, dzs, dzv, lamS, schur_mc, Lg,
         ok) = _reg_retry(factor, delta_last, opt, active)
        lamS = lamS * cm

        dz_all = scatter_dz(dzs, dzv)  # (B, m_c+n_g+1, N, d)
        Xz, Xlam = dz_all[:, :m_c], lamS[:, :m_c]
        Y, Ylam = dz_all[:, m_c : m_c + n_g], lamS[:, m_c : m_c + n_g]
        Ls = W1 = None
        if n_g:
            # M and T were factored and certified inside the retry
            Ls, W1 = schur_mc
            Hgg_d = Hgg_m + delta[:, None, None] * diag_gf
        elif m_c:
            Ls, ok_s = chol_or_eye(torch.einsum("bjnd,bknd->bjk", C, Xz)
                                   + torch.diag_embed(diag_e))
            ok = ok & ok_s

        def combine(dz0, lam0, rhs_c_flat, rg):
            """Schur-combine core solutions (L, N, d) with the border columns
            and, with globals, the arrowhead columns: 3 Newton passes of the
            factored block solve over (λc, δg) (the later two remove the δ_c
            perturbation), then correct dz and the core λ."""
            L = dz0.shape[0]
            if m_c == 0 and n_g == 0:
                return dz0, lam0, dz0.new_zeros((L, 0)), dz0.new_zeros((L, 0))
            rep = L // B

            def r(t):
                return t.repeat_interleave(rep, 0) if rep > 1 and t is not None else t

            C_r, Cg_r, Xz_r, Xlam_r, Ls_r, W1_r = map(r, (C, Cg, Xz, Xlam, Ls, W1))
            if n_g:
                Y_r, Ylam_r, Hzg_r, Hgg_r, Lg_r = map(r, (Y, Ylam, Hzg_m, Hgg_d, Lg))
            rf_r = r(refine_e) if n_ib else None
            rcc = border_rhs(rhs_c_flat)

            def block_solve(r1, r2):
                """[M W₁; −W₁ᵀ T](λc, δg) = (r1, r2) with the stored factors."""
                if not n_g:
                    return _chosolve(Ls_r, r1), None
                if not m_c:
                    return None, _chosolve(Lg_r, r2)
                t = r2 + torch.einsum("jmg,jm->jg", W1_r, _chosolve(Ls_r, r1))
                dg_ = _chosolve(Lg_r, t)
                return _chosolve(Ls_r, r1 - torch.einsum("jmg,jg->jm", W1_r, dg_)), dg_

            lam_c = dz0.new_zeros((L, m_c))
            dg = dz0.new_zeros((L, n_g))
            dz = dz0
            for _ in range(3):
                R1 = R2 = None
                if m_c:
                    R1 = torch.einsum("jmnd,jnd->jm", C_r, dz)
                    if n_g:
                        R1 = R1 + torch.einsum("jmg,jg->jm", Cg_r, dg)
                    R1 = R1 - rcc
                    if n_ib:
                        R1 = R1 - rf_r * lam_c
                if n_g:
                    R2 = (torch.einsum("jndg,jnd->jg", Hzg_r, dz)
                          + torch.einsum("jgh,jh->jg", Hgg_r, dg))
                    if m_c:
                        R2 = R2 + torch.einsum("jmg,jm->jg", Cg_r, lam_c)
                    R2 = -(R2 - rg)
                dlam, ddg = block_solve(R1, R2)
                dz = dz0
                if m_c:
                    lam_c = lam_c + dlam
                    dz = dz - torch.einsum("jmnd,jm->jnd", Xz_r, lam_c)
                if n_g:
                    dg = dg + ddg
                    dz = dz - torch.einsum("jgnd,jg->jnd", Y_r, dg)
            lam_stack = lam0
            if m_c:
                lam_stack = lam_stack - torch.einsum("jmkr,jm->jkr", Xlam_r, lam_c)
            if n_g:
                lam_stack = lam_stack - torch.einsum("jgkr,jg->jkr", Ylam_r, dg)
            if m_c:
                # undo the augmented-Lagrangian shift in the penalized rows'
                # multipliers: λc = λ̃c + ρ(C dz − r) there (penalized rows are
                # global-free, so the Cg·δg term is zero on them)
                r_b = torch.einsum("jmnd,jnd->jm", C_r, dz) - rcc
                lam_c = lam_c + rho * loc_border_mask * r_b
            return dz, lam_stack, lam_c, dg

        def resolve_many(rhs_z_stack, rhs_c_stack):
            """Solve R extra systems (B, R, ·) against the stored factors in
            one fused resolve sweep (SOC + restoration share one pass)."""
            R = rhs_z_stack.shape[1]
            rz = rho_adjust(rhs_z_stack[..., : N * d].reshape(B * R, N, d),
                            rhs_c_stack.reshape(B * R, -1))
            q1 = -rz.reshape(B, R, N, d)
            b1 = b_dyn_pad(rhs_c_stack.reshape(B * R, -1)).reshape(B, R, N, n_s)
            dzs1, dzv1, lam1 = riccati_kernel.resolve(
                s0m, P_all, Lv_all, Kg_all, Mvs_all, L0, Abar_p, Bbar_p,
                q1[..., s_ix], q1[..., v_ix], b1,
            )
            lam0 = (lam1 * cm).reshape(B * R, N - 1, n_s)
            dz0 = scatter_dz(dzs1, dzv1).reshape(B * R, N, d)
            dz, lam_stack, lam_c, dg = combine(
                dz0, lam0, rhs_c_stack.reshape(B * R, -1),
                rhs_z_stack[..., N * d :].reshape(B * R, n_g))
            dZ = dz.reshape(B, R, -1)
            if n_g:
                dZ = torch.cat([dZ, dg.reshape(B, R, n_g)], dim=-1)
            return dZ, pack_lam(lam_stack, lam_c).reshape(B, R, -1)

        def resolve(rhs_z, rhs_c_flat):
            dZ, lam = resolve_many(rhs_z[:, None], rhs_c_flat[:, None])
            return dZ[:, 0], lam[:, 0]

        resolve.many = resolve_many

        dz, lam_stack, lam_c, dg = combine(dz_all[:, m_c + n_g], lamS[:, m_c + n_g], rhs_c,
                                           -g_hat[:, N * d :] if n_g else None)
        dZ = dz.reshape(B, -1)
        if n_g:
            dZ = torch.cat([dZ, dg], dim=1)
        lam_plus = pack_lam(lam_stack, lam_c)
        ok = ok & torch.isfinite(dZ).all(-1) & torch.isfinite(lam_plus).all(-1)

        if self._lbfgs is not None:
            # Sherman–Morrison–Woodbury for the compact L-BFGS low-rank term:
            # the factored K₀ used W₀ = σI, the model is W = σI − UᵀM⁻¹U, so
            # K = K₀ + Ṽ(−M⁻¹)Ṽᵀ with Ṽ = [U; 0]ᵀ and
            # K⁻¹b = K₀⁻¹b − K₀⁻¹Ṽ (−M + ṼᵀK₀⁻¹Ṽ)⁻¹ ṼᵀK₀⁻¹b: 2m right-hand
            # sides through one resolve sweep and a (2m)×(2m) solve per lane
            _, U, Mlb = self._lbfgs
            Xz, Xlam = resolve_many(U, U.new_zeros((B, U.shape[1], nlp.n_eq)))
            Csmw = -Mlb + U @ Xz.transpose(-1, -2)
            base_many = resolve_many

            def smw(xz, xlam):
                """Correct R solutions (B, R, ·) of K₀ to solutions of K."""
                w = torch.linalg.solve(Csmw, U @ xz.transpose(-1, -2))  # (B, 2m, R)
                return (xz - (Xz.transpose(-1, -2) @ w).transpose(-1, -2),
                        xlam - (Xlam.transpose(-1, -2) @ w).transpose(-1, -2))

            dZ1, lam1 = smw(dZ[:, None], lam_plus[:, None])
            dZ, lam_plus = dZ1[:, 0], lam1[:, 0]
            ok = ok & torch.isfinite(dZ).all(-1) & torch.isfinite(lam_plus).all(-1)

            def resolve_many(rhs_z_stack, rhs_c_stack):
                return smw(*base_many(rhs_z_stack, rhs_c_stack))

            def resolve(rhs_z, rhs_c_flat):
                dZr, lamr = resolve_many(rhs_z[:, None], rhs_c_flat[:, None])
                return dZr[:, 0], lamr[:, 0]

            resolve.many = resolve_many
        return dZ, lam_plus, ok, delta, resolve


class RiccatiOps:
    """Operator backend using the block-structured Riccati KKT solve."""

    def __init__(self, nlp: CanonicalNLP):
        struct = analyze(nlp)
        if struct is None:
            raise ValueError("problem is not Riccati-eligible")
        self.nlp = nlp
        self.struct = struct

    def prepare(self, Z, lam, nu, cache=None, gauss_newton=False, stagewise=False,
                skip_hessian=False) -> _RiccatiCtx:
        """The iterate's context; ``skip_hessian`` (L-BFGS) skips every AD
        Hessian, the model arriving by :meth:`_RiccatiCtx.set_lbfgs`."""
        return _RiccatiCtx(self.nlp, self.struct, Z, lam, nu, cache, gauss_newton, stagewise,
                           skip_hessian)
