"""Block-structured Riccati KKT backend, main-path subset.

Counterpart of ``directtrajopt_tpu/solvers/ops_riccati.py``. Knot variables
split into states (integrator targets) and inputs; the condensed KKT system
is a time-varying LQR solved by the fused Riccati factor+solve kernel
(``ops/riccati_kernel.py``), whose per-stage Cholesky is the inertia
certificate of the δ_w retry ladder. Dynamics rows whose target coordinate
is pinned (the final-control pins) form a small border, solved by a Schur
complement over the factored core with an augmented-Lagrangian curvature
shift ρ·cᵀc on the owning knot.

Ported: ``analyze`` for explicit integrators with pins and bounds, the
prepare step (Jacobians, Lagrangian Hessian blocks, Gauss-Newton skipping
the constraint curvature), ``kkt_step`` with the border ``_combine`` and
``resolve`` / ``resolve.many``. Not ported yet (``analyze`` raises
``NotImplementedError``): chain promotion, affine and nonlinear border
rows, inequality rows, global variables (ROADMAP Queue 1 item 9), the
stagewise / project / flip regularizations (item 8) and L-BFGS (item 13).

All tensors carry a leading lane axis B.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from ..integrators.base import stack_hessians_zk, stack_jacobians_zk
from ..ops import riccati_kernel
from .assembly import gradient
from .canonical import CanonicalNLP
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
    """``(L Lᵀ)⁻¹ b`` for vectors b (..., n), unrolled (``_chosolve``)."""
    n = L.shape[-1]
    inv = [1.0 / L[..., i, i] for i in range(n)]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s * inv[i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s * inv[i]
    return torch.stack(x, dim=-1)


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


def analyze(nlp: CanonicalNLP) -> OCPStructure | None:
    """Check Riccati eligibility and build the static structure."""
    layout = nlp.layout
    N, d = layout.N, layout.dim
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
    if nlp.eq_entries or nlp.in_entries or nlp.n_nl_eq or nlp.n_nl_in:
        raise NotImplementedError(
            "chain promotion, affine / nonlinear border rows and inequality rows "
            "are not ported to the Riccati backend yet (ROADMAP Queue 1 item 9)"
        )
    s_idx = np.asarray(s_list, dtype=np.int64)
    v_idx = np.asarray([i for i in range(d) if i not in set(s_list)], dtype=np.int64)
    n_s = len(s_idx)

    free = np.ones(N * d)
    free[nlp.fix_idx] = 0.0
    free_blk = free.reshape(N, d)
    # dynamics rows whose target coordinate is pinned go to the border
    target_flat = (np.arange(1, N)[:, None] * d) + s_idx[None, :]
    pinned = np.zeros(N * d, dtype=bool)
    pinned[nlp.fix_idx] = True
    bp = pinned[target_flat]
    core_mask = (~bp).astype(np.float64)
    bp_steps, bp_rows = np.nonzero(bp)

    dyn_flat = np.zeros((N - 1, n_s), dtype=np.int64)
    off = 0
    for pos, r in s_pos:
        for k in range(N - 1):
            dyn_flat[k, pos : pos + r] = off + k * r + np.arange(r)
        off += r * (N - 1)
    return OCPStructure(
        N=N, d=d, s_idx=s_idx, v_idx=v_idx, s_pos=s_pos, free_blk=free_blk,
        core_mask=core_mask, bp_steps=bp_steps, bp_rows=bp_rows,
        bp_flat=dyn_flat[bp_steps, bp_rows], dyn_flat_of_stack=dyn_flat,
        s0_mask=free_blk[0, s_idx].copy(),
    )


def _knot_hessians(obj, layout, zmat: torch.Tensor) -> torch.Tensor:
    """Per-knot Hessians (B, N, d, d) of a knot-separable objective, by
    forward-over-reverse AD: one tangent per coordinate, applied to every
    knot of every lane at once."""
    g = grad(lambda z: obj.cost_at_knot(layout, z).sum())
    eye = torch.eye(layout.dim, dtype=zmat.dtype, device=zmat.device)
    return vmap(lambda e: jvp(g, (zmat,), (e.expand_as(zmat),))[1], out_dims=-1)(eye)


class _RiccatiCtx:
    def __init__(self, nlp: CanonicalNLP, S: OCPStructure, Z, lam, nu, cache=None,
                 gauss_newton: bool = False):
        self.nlp = nlp
        self.S = S
        layout = nlp.layout
        N, d = S.N, S.d
        B = Z.shape[0]
        dtype, dev = Z.dtype, Z.device
        self.dtype = dtype
        zmat = Z.reshape(B, N, d)
        self.grad_f = gradient(nlp, Z)
        if cache is not None:
            self.c_e, self.c_i = cache
        else:
            self.c_e, self.c_i = nlp.c_eq(Z), nlp.c_in(Z)
        self.Jr = torch.cat(
            [stack_jacobians_zk(integ, layout, zmat) for integ in nlp.integrators], dim=2
        )  # (B, N-1, n_s, d)
        QW = _knot_hessians(nlp.objective_obj, layout, zmat)
        if not gauss_newton:
            # Gauss-Newton drops the λ-weighted constraint curvature
            off = 0
            for integ, (_, r) in zip(nlp.integrators, S.s_pos):
                mu = lam[:, off : off + r * (N - 1)].reshape(B, N - 1, r)
                blocks = stack_hessians_zk(integ, layout, zmat, mu)
                QW = torch.cat([QW[:, : N - 1] + blocks, QW[:, N - 1 :]], dim=1)
                off += r * (N - 1)
        self.QW = QW
        self.f_blk = torch.as_tensor(S.free_blk, dtype=dtype, device=dev)
        self._dyn = torch.as_tensor(S.dyn_flat_of_stack.reshape(-1), device=dev)
        self._s_ix = torch.as_tensor(S.s_idx, device=dev)
        self._v_ix = torch.as_tensor(S.v_idx, device=dev)

    # ---------------- matvecs ---------------------------------------------- #

    def JeT(self, v: torch.Tensor) -> torch.Tensor:
        S = self.S
        N, d, n_s = S.N, S.d, len(S.s_idx)
        B = v.shape[0]
        vd = v[:, self._dyn].reshape(B, N - 1, n_s)
        out = torch.zeros((B, N, d), dtype=v.dtype, device=v.device)
        out[:, : N - 1] += torch.einsum("bkrd,bkr->bkd", self.Jr, vd)
        out[:, 1:, self._s_ix] += vd
        return out.reshape(B, -1)

    def JiT(self, v: torch.Tensor) -> torch.Tensor:
        return torch.zeros((v.shape[0], self.nlp.z_dim), dtype=v.dtype, device=v.device)

    # ---------------- KKT solve -------------------------------------------- #

    def kkt_step(self, Sig, D, g_hat, rhs_c, delta_last, opt, active=None):
        S = self.S
        N, d = S.N, S.d
        n_s = len(S.s_idx)
        B = Sig.shape[0]
        dtype, dev = self.dtype, Sig.device
        f_blk = self.f_blk
        s_ix, v_ix = self._s_ix, self._v_ix

        # ---- condensed per-knot Hessian blocks: pins → identity rows ----- #
        Q = self.QW * f_blk[:, :, None] * f_blk[:, None, :]
        Q = Q + torch.diag_embed(1.0 - f_blk)
        Q = Q + torch.diag_embed(Sig.reshape(B, N, d))

        # ---- dynamics blocks ---------------------------------------------- #
        Jr_m = self.Jr * f_blk[: N - 1, None, :]
        cm = torch.as_tensor(S.core_mask, dtype=dtype, device=dev)
        A_full = -Jr_m * cm[:, :, None]
        zpad_s = torch.zeros((B, 1, n_s, n_s), dtype=dtype, device=dev)
        zpad_v = torch.zeros((B, 1, n_s, len(S.v_idx)), dtype=dtype, device=dev)
        Abar_p = torch.cat([A_full[..., s_ix], zpad_s], dim=1)
        Bbar_p = torch.cat([A_full[..., v_ix], zpad_v], dim=1)

        # ---- border rows: pinned-target dynamics rows --------------------- #
        m_c = len(S.bp_steps)
        bp_steps = torch.as_tensor(S.bp_steps, device=dev)
        bp_flat = torch.as_tensor(S.bp_flat, device=dev)
        rho = opt.border_penalty
        lv = Jr_m[:, bp_steps, torch.as_tensor(S.bp_rows, device=dev), :]  # (B, m_c, d)
        C = torch.zeros((B, m_c, N, d), dtype=dtype, device=dev)
        C[:, torch.arange(m_c, device=dev), bp_steps, :] = lv
        # augmented-Lagrangian curvature shift ρ·cᵀc on the owning knot
        Q = Q.index_add(1, bp_steps, rho * lv[:, :, None, :] * lv[:, :, :, None])

        Qss = Q[:, :, s_ix][:, :, :, s_ix]
        Qsv = Q[:, :, s_ix][:, :, :, v_ix]
        Qvv = Q[:, :, v_ix][:, :, :, v_ix]
        fS = torch.diag_embed(f_blk[:, s_ix])
        fV = torch.diag_embed(f_blk[:, v_ix])

        def rho_adjust(rhs_z_blk, rhs_c_flat):
            """Rhs shift matching the ρ·cᵀc in Q; (L, N, d), (L, n_eq) with
            L a multiple of B (lane-major repeats)."""
            rep = rhs_z_blk.shape[0] // B
            lv_r = lv.repeat_interleave(rep, 0) if rep > 1 else lv
            r_loc = rhs_c_flat[:, bp_flat]
            return rhs_z_blk + torch.zeros_like(rhs_z_blk).index_add(
                1, bp_steps, rho * lv_r * r_loc[:, :, None]
            )

        def b_dyn_pad(rhs_c_flat):
            L = rhs_c_flat.shape[0]
            b_dyn = rhs_c_flat[:, self._dyn].reshape(L, N - 1, n_s) * cm
            return torch.cat([b_dyn, torch.zeros((L, 1, n_s), dtype=dtype, device=dev)], dim=1)

        rhs_main = rho_adjust((-g_hat).reshape(B, N, d), rhs_c)
        q_all = torch.cat([-C, -rhs_main[:, None]], dim=1)  # (B, m_c+1, N, d)
        b_all = torch.cat(
            [torch.zeros((B, m_c, N, n_s), dtype=dtype, device=dev), b_dyn_pad(rhs_c)[:, None]],
            dim=1,
        )
        qs_all = q_all[..., s_ix]
        qv_all = q_all[..., v_ix]
        s0m = S.s0_mask

        def factor(delta):
            dsh = delta[:, None, None, None]
            P, Lv, Kg, Mvs, L0, okf, dzs, dzv, lamS = riccati_kernel.factor_solve(
                s0m, Qss + dsh * fS, Qsv, Qvv + dsh * fV, Abar_p, Bbar_p,
                qs_all, qv_all, b_all,
            )
            return P, Lv, Kg, Mvs, L0, dzs, dzv, lamS, okf

        delta, P_all, Lv_all, Kg_all, Mvs_all, L0, dzs, dzv, lamS, ok = _reg_retry(
            factor, delta_last, opt, active
        )
        lamS = lamS * cm

        def scatter_dz(dzs_, dzv_):
            out = torch.zeros(dzs_.shape[:-1] + (d,), dtype=dtype, device=dev)
            out[..., s_ix] = dzs_
            out[..., v_ix] = dzv_
            return out

        dz_all = scatter_dz(dzs, dzv)  # (B, m_c+1, N, d)
        Xz, Xlam = dz_all[:, :m_c], lamS[:, :m_c]
        if m_c:
            Smat = torch.einsum("bjnd,bknd->bjk", C, Xz) + torch.diag(
                torch.full((m_c,), opt.delta_c, dtype=dtype, device=dev))
            Ls = _chol(Smat)
            fin = torch.isfinite(Ls)
            ok_s = fin.all(-1).all(-1)
            Ls = torch.where(fin, Ls, torch.eye(m_c, dtype=dtype, device=dev))
        else:
            ok_s = torch.ones((B,), dtype=torch.bool, device=dev)

        def combine(dz0, lam0, rhs_c_flat):
            """Schur-combine core solutions (L, N, d) with the border columns:
            3 Newton passes on the border multipliers (the later two remove
            the δ_c perturbation), then correct dz and the core λ."""
            if m_c == 0:
                return dz0, lam0, dz0.new_zeros((dz0.shape[0], 0))
            rep = dz0.shape[0] // B

            def r(t):
                return t.repeat_interleave(rep, 0) if rep > 1 else t

            C_r, Xz_r, Xlam_r, Ls_r, = r(C), r(Xz), r(Xlam), r(Ls)
            rcc = rhs_c_flat[:, bp_flat]
            lam_c = dz0.new_zeros((dz0.shape[0], m_c))
            dz = dz0
            for _ in range(3):
                R1 = torch.einsum("jmnd,jnd->jm", C_r, dz) - rcc
                lam_c = lam_c + _chosolve(Ls_r, R1)
                dz = dz0 - torch.einsum("jmnd,jm->jnd", Xz_r, lam_c)
            lam_stack = lam0 - torch.einsum("jmkr,jm->jkr", Xlam_r, lam_c)
            r_b = torch.einsum("jmnd,jnd->jm", C_r, dz) - rcc
            # undo the augmented-Lagrangian shift in the border multipliers
            lam_c = lam_c + rho * r_b
            return dz, lam_stack, lam_c

        def pack_lam(lam_stack, lam_c):
            L = lam_stack.shape[0]
            lam_flat = torch.zeros((L, self.nlp.n_eq), dtype=dtype, device=dev)
            lam_flat[:, self._dyn] = lam_stack.reshape(L, -1)
            lam_flat[:, bp_flat] = lam_c
            return lam_flat

        def resolve_many(rhs_z_stack, rhs_c_stack):
            """Solve R extra systems (B, R, ·) against the stored factors in
            one fused resolve sweep (SOC + restoration share one pass)."""
            R = rhs_z_stack.shape[1]
            rz = rho_adjust(rhs_z_stack.reshape(B * R, N, d), rhs_c_stack.reshape(B * R, -1))
            q1 = -rz.reshape(B, R, N, d)
            b1 = b_dyn_pad(rhs_c_stack.reshape(B * R, -1)).reshape(B, R, N, n_s)
            dzs1, dzv1, lam1 = riccati_kernel.resolve(
                s0m, P_all, Lv_all, Kg_all, Mvs_all, L0, Abar_p, Bbar_p,
                q1[..., s_ix], q1[..., v_ix], b1,
            )
            lam0 = (lam1 * cm).reshape(B * R, N - 1, n_s)
            dz0 = scatter_dz(dzs1, dzv1).reshape(B * R, N, d)
            dz, lam_stack, lam_c = combine(dz0, lam0, rhs_c_stack.reshape(B * R, -1))
            return dz.reshape(B, R, -1), pack_lam(lam_stack, lam_c).reshape(B, R, -1)

        def resolve(rhs_z, rhs_c_flat):
            dZ, lam = resolve_many(rhs_z[:, None], rhs_c_flat[:, None])
            return dZ[:, 0], lam[:, 0]

        resolve.many = resolve_many

        dz, lam_stack, lam_c = combine(dz_all[:, m_c], lamS[:, m_c], rhs_c)
        dZ = dz.reshape(B, -1)
        lam_plus = pack_lam(lam_stack, lam_c)
        ok = ok & ok_s & torch.isfinite(dZ).all(-1) & torch.isfinite(lam_plus).all(-1)
        return dZ, lam_plus, ok, delta, resolve


class RiccatiOps:
    """Operator backend using the block-structured Riccati KKT solve."""

    def __init__(self, nlp: CanonicalNLP):
        struct = analyze(nlp)
        if struct is None:
            raise ValueError("problem is not Riccati-eligible")
        self.nlp = nlp
        self.struct = struct

    def prepare(self, Z, lam, nu, cache=None, gauss_newton=False) -> _RiccatiCtx:
        return _RiccatiCtx(self.nlp, self.struct, Z, lam, nu, cache, gauss_newton)
