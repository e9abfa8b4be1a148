"""Batched primal-dual interior-point method.

Counterpart of ``directtrajopt_tpu/solvers/ipm.py`` (Wächter–Biegler filter
IPM): log barrier for box bounds, condensed KKT through the Riccati
backend with δ_w inertia control, fraction-to-boundary, a filter line
search whose backtracking grid, second-order correction (SOC) and
restoration slots are evaluated as one batched trial pass, the monotone
barrier schedule, acceptable-level termination, the μ-tied proximal δ_w
floor, the oscillation watchdog and the error-free transforms of
``compensated_residuals``.

The JAX package ``vmap``s a per-problem ``while_loop``. Here the loop is
written batch-first: every state field carries a leading lane axis, the
body runs on all lanes, and ``torch.where`` keeps each lane whose loop
predicate is false frozen — exactly the semantics of a vmapped while loop,
so per-lane iteration counts match the JAX solve.

Not ported yet (``IPMOptions.check_supported`` raises): the Mehrotra and
adaptive μ strategies, residual refinement, the non-monotone line search,
L-BFGS, least-squares dual initialization, callbacks and telemetry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..module import tree_where
from .canonical import CanonicalNLP
from .options import IPMOptions

__all__ = ["IPMState", "IPMResult", "WarmStart", "ipm_solve"]

_BIG = 1e20
_FILTER_SIZE = 64
_GAMMA_THETA = 1e-5
_GAMMA_PHI = 1e-8
_S_THETA = 1.1
_S_PHI = 2.3


class WarmStart(NamedTuple):
    """Slacks and duals carried from a previous solve (the primal travels in
    the trajectory itself)."""

    s: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    zL: torch.Tensor
    zU: torch.Tensor


class IPMState(NamedTuple):
    Z: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    zL: torch.Tensor
    zU: torch.Tensor
    mu: torch.Tensor
    theta_max: torch.Tensor
    theta_min: torch.Tensor
    filter_th: torch.Tensor  # (B, F) filter θ entries (+inf = empty)
    filter_ph: torch.Tensor
    filter_n: torch.Tensor
    c_e: torch.Tensor  # residuals at Z, carried from the line search
    c_i: torch.Tensor
    delta_w_last: torch.Tensor
    stall_count: torch.Tensor
    infeasible: torch.Tensor
    rest_failed: torch.Tensor
    diverged: torch.Tensor
    iter: torch.Tensor
    converged: torch.Tensor
    acc_count: torch.Tensor
    err: torch.Tensor
    obj: torch.Tensor
    best_kkt: torch.Tensor
    best_kkt_ok: torch.Tensor
    best_kkt_Z: torch.Tensor
    best_kkt_obj: torch.Tensor
    best_kkt_warm: WarmStart
    obj_prev: torch.Tensor
    osc_count: torch.Tensor
    delta_w_boost: torch.Tensor


class IPMResult(NamedTuple):
    Z: torch.Tensor
    state: IPMState
    iterations: torch.Tensor
    converged: torch.Tensor
    status: torch.Tensor  # 0 optimal, 1 acceptable, 2 iteration limit,
    # 4 locally infeasible, 5 restoration failed, 6 diverging iterates
    kkt_error: torch.Tensor
    objective: torch.Tensor


# ---- error-free transforms (options.compensated_residuals) ---------------- #
# Eager PyTorch runs each operation as its own kernel, rounding after every
# one (no FMA contraction, no reassociation), so these identities hold.


def _two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly, s = fl(a+b)."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _csum(terms):
    """Compensated (cascaded two-sum) summation of a list of tensors."""
    s, e = terms[0], None
    for t in terms[1:]:
        s, err = _two_sum(s, t)
        e = err if e is None else e + err
    return s if e is None else s + e


def _two_prod_f32(a, b):
    """Dekker two-prod via Veltkamp split (float32: split at 2^12+1):
    p + e == a·b exactly, p = fl(a·b)."""
    SPLIT = 4097.0
    ca = a * SPLIT
    ah = ca - (ca - a)
    al = a - ah
    cb = b * SPLIT
    bh = cb - (cb - b)
    bl = b - bh
    p = a * b
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _amax0(x: torch.Tensor) -> torch.Tensor:
    """``max(x, initial=0)`` over the last axis (0 for an empty axis)."""
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    return torch.clamp(x.amax(-1), min=0.0)


def _masked_min(x, mask, initial: float):
    """``min(where(mask, x, initial), initial=initial)`` over the last axis;
    ``initial`` for an all-false mask."""
    return torch.clamp(torch.where(mask, x, initial).amin(-1), max=initial)


def _lane(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """View per-lane ``t`` (B, ...) with singleton axes for ``like``'s extra
    axes after the lane axis."""
    return t.reshape(t.shape[:1] + (1,) * (like.ndim - t.ndim) + t.shape[1:])


def ipm_solve(nlp: CanonicalNLP, Z0: torch.Tensor, options: IPMOptions, ops,
              warm: WarmStart | None = None) -> IPMResult:
    """Run the interior-point method from ``Z0`` (B, z_dim) on every lane."""
    options.check_supported()
    dtype, dev = Z0.dtype, Z0.device
    B = Z0.shape[0]
    comp = bool(options.compensated_residuals) and dtype == torch.float32
    opt = options.astype(dtype)
    mu_floor = max(opt.mu_min, opt.tol / 10.0)
    z_dim, n_eq, n_in = nlp.z_dim, nlp.n_eq, nlp.n_in
    if n_in:
        raise NotImplementedError("inequality rows are not ported yet (ROADMAP Queue 1 item 9)")
    lb, ub = nlp.lb, nlp.ub
    free = nlp.free_mask
    has_L, has_U = torch.isfinite(lb), torch.isfinite(ub)
    mask_L = has_L & (free > 0)
    mask_U = has_U & (free > 0)
    inf = float("inf")

    def full(v, dt=dtype):
        return torch.full((B,), v, dtype=dt, device=dev)

    def bound_dists(Z):
        dL = torch.where(_lane(has_L, Z), Z - _lane(lb, Z), 1.0)
        dU = torch.where(_lane(has_U, Z), _lane(ub, Z) - Z, 1.0)
        return dL, dU

    # ---------------- initialization (Ipopt §3.6) ------------------------- #
    Z0 = nlp.apply_pins(Z0)
    gap = torch.where(has_L & has_U, ub - lb, inf)
    pl = torch.minimum(opt.bound_push * torch.clamp(lb.abs(), min=1.0), opt.bound_frac * gap)
    pu = torch.minimum(opt.bound_push * torch.clamp(ub.abs(), min=1.0), opt.bound_frac * gap)
    Z_init = torch.where(mask_L, torch.maximum(Z0, lb + pl), Z0)
    Z_init = torch.where(mask_U, torch.minimum(Z_init, ub - pu), Z_init)

    c_i0 = nlp.c_in(Z_init)
    s_init = torch.clamp(-c_i0 + opt.bound_push, min=opt.slack_min)
    mu0 = opt.mu_init
    dL0, dU0 = bound_dists(Z_init)
    zL0 = torch.where(mask_L, mu0 / dL0, 0.0)
    zU0 = torch.where(mask_U, mu0 / dU0, 0.0)
    nu0 = mu0 / s_init
    lam0 = torch.zeros((B, n_eq), dtype=dtype, device=dev)
    if warm is not None:
        s_init = torch.clamp(warm.s.to(dtype), min=opt.slack_min)
        nu0 = torch.clamp(warm.nu.to(dtype), min=opt.slack_min)
        zL0 = torch.where(mask_L, torch.clamp(warm.zL.to(dtype), min=opt.slack_min), 0.0)
        zU0 = torch.where(mask_U, torch.clamp(warm.zU.to(dtype), min=opt.slack_min), 0.0)
        lam0 = warm.lam.to(dtype)
    c_e0 = nlp.c_eq(Z_init)
    theta_init = c_e0.abs().sum(-1) + (c_i0 + s_init).abs().sum(-1)
    gn = options.hessian_approximation == "gauss_newton"
    obj0 = nlp.objective(Z_init)
    i32 = torch.int32

    state0 = IPMState(
        Z=Z_init, s=s_init, lam=lam0, nu=nu0, zL=zL0, zU=zU0,
        mu=full(mu0),
        theta_max=1e4 * torch.clamp(theta_init, min=1.0),
        theta_min=1e-4 * torch.clamp(theta_init, min=1.0),
        filter_th=torch.full((B, _FILTER_SIZE), inf, dtype=dtype, device=dev),
        filter_ph=torch.full((B, _FILTER_SIZE), inf, dtype=dtype, device=dev),
        filter_n=full(0, i32),
        c_e=c_e0, c_i=c_i0,
        delta_w_last=full(0.0),
        stall_count=full(0, i32),
        infeasible=full(False, torch.bool),
        rest_failed=full(False, torch.bool),
        diverged=full(False, torch.bool),
        iter=full(0, i32),
        converged=full(False, torch.bool),
        acc_count=full(0, i32),
        err=full(_BIG),
        obj=obj0,
        best_kkt=full(_BIG),
        best_kkt_ok=full(False, torch.bool),
        best_kkt_Z=Z_init,
        best_kkt_obj=obj0,
        best_kkt_warm=WarmStart(s=s_init, lam=lam0, nu=nu0, zL=zL0, zU=zU0),
        obj_prev=full(inf),
        osc_count=full(0, i32),
        delta_w_boost=full(1.0),
    )
    s_max = 100.0

    def _bar(Z, s):
        dL, dU = bound_dists(Z)
        return (
            torch.where(_lane(mask_L, Z), torch.log(dL), 0.0).sum(-1)
            + torch.where(_lane(mask_U, Z), torch.log(dU), 0.0).sum(-1)
            + torch.log(s).sum(-1)
        )

    def barrier_phi_from(f, Z, s, mu, c_e, c_i):
        theta = c_e.abs().sum(-1) + (c_i + s).abs().sum(-1)
        return f - _lane(mu, f) * _bar(Z, s), theta

    def body(st: IPMState, active: torch.Tensor) -> IPMState:
        Z, s, lam, nu, zL, zU = st.Z, st.s, st.lam, st.nu, st.zL, st.zU
        dL, dU = bound_dists(Z)
        ctx = ops.prepare(Z, lam, nu, cache=(st.c_e, st.c_i), gauss_newton=gn)
        gf, c_e, c_i = ctx.grad_f, ctx.c_e, ctx.c_i

        # ---- optimality errors at the current iterate -------------------- #
        if comp:
            # five O(1) terms cancelling to O(tol): compensated summation
            r_dual = free * _csum([gf, ctx.JeT(lam), ctx.JiT(nu), -zL, zU])
        else:
            r_dual = free * (gf + ctx.JeT(lam) + ctx.JiT(nu) - zL + zU)
        z_sum = lam.abs().sum(-1) + nu.abs().sum(-1)
        b_sum = zL.abs().sum(-1) + zU.abs().sum(-1)
        n_tot = max(1, n_eq + n_in + 2 * z_dim)
        s_d = torch.clamp((z_sum + b_sum) / n_tot, min=s_max) / s_max
        s_c = torch.clamp(b_sum / max(1, 2 * z_dim), min=s_max) / s_max
        inf_du = _amax0(r_dual.abs())
        inf_pr = torch.maximum(_amax0(c_e.abs()), _amax0((c_i + s).abs()))

        def comp_err(mu_val):
            if comp:
                # d·z ≈ μ only by cancellation: exact-product transforms
                pL, eL = _two_prod_f32(dL, zL)
                pU, eU = _two_prod_f32(dU, zU)
                ps, es = _two_prod_f32(s, nu)
                comp_L = torch.where(mask_L, (pL - mu_val) + eL, 0.0)
                comp_U = torch.where(mask_U, (pU - mu_val) + eU, 0.0)
                comp_s = (ps - mu_val) + es
            else:
                comp_L = torch.where(mask_L, dL * zL - mu_val, 0.0)
                comp_U = torch.where(mask_U, dU * zU - mu_val, 0.0)
                comp_s = s * nu - mu_val
            return torch.maximum(
                torch.maximum(_amax0(comp_L.abs()), _amax0(comp_U.abs())),
                _amax0(comp_s.abs()),
            )

        base_err = torch.maximum(inf_du / s_d, inf_pr)
        comp0 = comp_err(0.0)
        e_mu = torch.maximum(base_err, comp_err(st.mu[:, None]) / s_c)
        e_0 = torch.maximum(base_err, comp0 / s_c)

        unscaled_ok = (
            (inf_du <= opt.dual_inf_tol)
            & (inf_pr <= opt.constr_viol_tol)
            & (comp0 <= opt.compl_inf_tol)
        )
        conv_now = (e_0 <= opt.tol) & unscaled_ok
        acc_ok = (
            (e_0 <= opt.acceptable_tol)
            & (inf_pr <= opt.acceptable_constr_viol_tol)
            & (inf_du <= opt.acceptable_dual_inf_tol)
            & (comp0 <= opt.acceptable_compl_inf_tol)
            & ((st.obj - st.obj_prev).abs()
               <= opt.acceptable_obj_change_tol * torch.clamp(st.obj.abs(), min=1.0))
        )
        acc_count = torch.where(acc_ok, st.acc_count + 1, 0).to(i32)
        stop_now = conv_now | (acc_count >= options.acceptable_iter)

        # best-iterate retention (the result reports the argmin-KKT iterate)
        improved = e_0 < st.best_kkt
        best_kkt = torch.where(improved, e_0, st.best_kkt)
        best_kkt_ok = torch.where(improved, unscaled_ok, st.best_kkt_ok)
        best_kkt_Z = torch.where(improved[:, None], Z, st.best_kkt_Z)
        best_kkt_obj = torch.where(improved, st.obj, st.best_kkt_obj)
        best_kkt_warm = tree_where(
            improved, WarmStart(s=s, lam=lam, nu=nu, zL=zL, zU=zU), st.best_kkt_warm
        )

        # ---- monotone barrier update (+ filter reset) --------------------- #
        switch_level = opt.mu_switch_factor * opt.tol
        endgame = st.mu <= switch_level
        k_eps_far = opt.kappa_epsilon_far if opt.kappa_epsilon_far > 0 else opt.kappa_epsilon
        k_mu_far = opt.kappa_mu_far if opt.kappa_mu_far > 0 else opt.kappa_mu
        k_eps = torch.where(endgame, full(opt.kappa_epsilon), full(k_eps_far))
        k_mu = torch.where(endgame, full(opt.kappa_mu), full(k_mu_far))
        mu_update = e_mu <= k_eps * st.mu
        mu_raw = torch.clamp(torch.minimum(k_mu * st.mu, st.mu ** opt.theta_mu), min=mu_floor)
        mu_raw = torch.where(endgame, mu_raw, torch.clamp(mu_raw, min=switch_level))
        mu = torch.where(mu_update, mu_raw, st.mu)
        filter_th = torch.where(mu_update[:, None], inf, st.filter_th)
        filter_ph = torch.where(mu_update[:, None], inf, st.filter_ph)
        filter_n = torch.where(mu_update, 0, st.filter_n).to(i32)

        # ---- condensed system ------------------------------------------- #
        SigL = torch.where(mask_L, zL / dL, 0.0)
        SigU = torch.where(mask_U, zU / dU, 0.0)
        Sig = (SigL + SigU) * free
        D = torch.zeros((B, 0), dtype=dtype, device=dev)
        # per-iteration proximal δ_w floor with the lane's watchdog boost
        opt_k = opt.replace(
            delta_w_min=torch.clamp(opt.delta_w_mu_scale * mu * st.delta_w_boost,
                                    min=opt.delta_w_min)
        )
        mu_c = mu[:, None]
        g_hat = free * (gf - torch.where(mask_L, mu_c / dL, 0.0)
                        + torch.where(mask_U, mu_c / dU, 0.0))
        dZ, lam_plus, ok, delta_fin, resolve = ctx.kkt_step(
            Sig, D, g_hat, -c_e, st.delta_w_last, opt_k, active
        )

        # ---- recover eliminated directions ------------------------------- #
        ds = torch.zeros((B, 0), dtype=dtype, device=dev)
        dnu = torch.zeros((B, 0), dtype=dtype, device=dev)
        dzL = torch.where(mask_L, mu_c / dL - zL - SigL * dZ, 0.0)
        dzU = torch.where(mask_U, mu_c / dU - zU + SigU * dZ, 0.0)

        # ---- fraction-to-boundary step sizes ----------------------------- #
        tau = torch.clamp(1.0 - mu, min=opt.tau_min)[:, None]

        def max_primal_step(dZ_):
            return torch.minimum(
                _masked_min(-tau * dL / torch.clamp(dZ_, max=-1e-30), mask_L & (dZ_ < 0), 1.0),
                _masked_min(tau * dU / torch.clamp(dZ_, min=1e-30), mask_U & (dZ_ > 0), 1.0),
            )

        a_pri = max_primal_step(dZ)
        a_dual = torch.minimum(
            _masked_min(-tau * zL / torch.clamp(dzL, max=-1e-30), mask_L & (dzL < 0), 1.0),
            _masked_min(-tau * zU / torch.clamp(dzU, max=-1e-30), mask_U & (dzU < 0), 1.0),
        )

        # ---- filter line search with second-order correction ------------- #
        phi0, theta0 = barrier_phi_from(st.obj, Z, s, mu, c_e, c_i)
        Dphi = (
            (gf * dZ).sum(-1)
            - mu * torch.where(mask_L, dZ / dL, 0.0).sum(-1)
            + mu * torch.where(mask_U, dZ / dU, 0.0).sum(-1)
        )
        phi_ref = phi0

        def acceptable(alpha, phi_t, theta_t):
            """Filter / Armijo acceptance; trial axes after the lane axis."""
            def ln(t):
                return _lane(t, phi_t)

            fshape = (B,) + (1,) * (phi_t.ndim - 1) + (_FILTER_SIZE,)
            fth, fph = filter_th.reshape(fshape), filter_ph.reshape(fshape)
            vs_filter = (
                (theta_t[..., None] <= (1.0 - _GAMMA_THETA) * fth)
                | (phi_t[..., None] <= fph - _GAMMA_PHI * fth)
            ).all(-1)
            Dp, th0, p0, pr = ln(Dphi), ln(theta0), ln(phi0), ln(phi_ref)
            switch = (Dp < 0) & (alpha * (-Dp) ** _S_PHI > th0 ** _S_THETA)
            armijo = phi_t <= pr + opt.eta_ls * alpha * Dp
            sufficient = (theta_t <= (1.0 - _GAMMA_THETA) * th0) | (
                phi_t <= pr - _GAMMA_PHI * th0
            )
            accept = torch.where(switch & (th0 <= ln(st.theta_min)), armijo, sufficient)
            f_type = switch & (phi_t <= p0 + opt.eta_ls * alpha * Dp)
            accept = (
                accept & vs_filter & (theta_t <= ln(st.theta_max))
                & torch.isfinite(phi_t) & torch.isfinite(theta_t)
            )
            if opt.theta_growth_cap > 0:
                cap = torch.clamp(opt.theta_growth_cap * th0, min=ln(st.theta_min))
                accept = accept & (theta_t <= cap)
            return accept, f_type

        # first trial at the full step; its residuals are shared with the SOC
        Z_full = nlp.apply_pins(Z + a_pri[:, None] * dZ)
        s_full = s + a_pri[:, None] * ds
        c_e_full = nlp.c_eq(Z_full)
        c_i_full = nlp.c_in(Z_full)
        f_full = nlp.objective(Z_full)
        phi_1, theta_1 = barrier_phi_from(f_full, Z_full, s_full, mu, c_e_full, c_i_full)
        acc_1, ftype_1 = acceptable(a_pri, phi_1, theta_1)

        c_soc = a_pri[:, None] * c_e + c_e_full
        g_soc = torch.zeros((B, z_dim), dtype=dtype, device=dev)
        n_rest = options.n_rest_trials if (n_eq or n_in) else 0
        soc_on = options.max_soc > 0
        rest_rhs = []
        if soc_on:
            rest_rhs.append((-g_hat - g_soc, -c_soc))
        if n_rest:
            rest_rhs.append((torch.zeros((B, z_dim), dtype=dtype, device=dev), -c_e))
        if len(rest_rhs) == 2:
            # SOC and restoration share ONE multi-RHS resolve sweep
            dZ2, lam2 = resolve.many(
                torch.stack([rest_rhs[0][0], rest_rhs[1][0]], dim=1),
                torch.stack([rest_rhs[0][1], rest_rhs[1][1]], dim=1),
            )
            dZ_soc, lam_soc = dZ2[:, 0], lam2[:, 0]
            dZ_r = dZ2[:, 1]
        elif soc_on:
            dZ_soc, lam_soc = resolve(*rest_rhs[0])
        elif n_rest:
            dZ_r, _ = resolve(*rest_rhs[0])
            dZ_soc, lam_soc = dZ, lam_plus
        else:
            dZ_soc, lam_soc = dZ, lam_plus
        a_soc = max_primal_step(dZ_soc) if soc_on else full(0.0)
        if n_rest:
            a_r = max_primal_step(dZ_r)
        else:
            dZ_r = dZ
            a_r = full(0.0)

        # parallel trial grid: [backtracking | restoration | SOC | α_min]
        n_bt = options.max_ls - n_rest
        n_grid = n_bt + n_rest
        alpha_min = a_pri * (0.5 ** opt.max_ls)
        ar = lambda lo, hi: torch.arange(lo, hi, dtype=dtype, device=dev)  # noqa: E731
        alphas_all = torch.cat(
            [a_pri[:, None] * (0.5 ** ar(1, n_bt + 1)), a_r[:, None] * (0.5 ** ar(0, n_rest)),
             a_soc[:, None], alpha_min[:, None]], dim=1,
        )
        is_rest = torch.cat([torch.zeros(n_bt, dtype=torch.bool, device=dev),
                             torch.ones(n_rest, dtype=torch.bool, device=dev)])
        dir_idx = torch.as_tensor([0] * n_bt + [1] * n_rest + [2, 0], device=dev)
        dZ_trials = torch.stack([dZ, dZ_r, dZ_soc], dim=1)[:, dir_idx]
        Zt = nlp.apply_pins(Z[:, None] + alphas_all[..., None] * dZ_trials)
        st_ = s[:, None] + alphas_all[..., None] * ds[:, None]
        c_i_t = nlp.c_in(Zt)
        fs_all = nlp.objective(Zt)
        # θ via the fused Σ|c_eq| path (the L1 form of the residual kernel)
        thetas_all = nlp.c_eq_l1(Zt) + (c_i_t + st_).abs().sum(-1)
        phis_all = fs_all - mu[:, None] * _bar(Zt, st_)

        phi_s, theta_s = phis_all[:, n_grid], thetas_all[:, n_grid]
        acc_s, ftype_s = acceptable(a_soc, phi_s, theta_s)
        use_soc = (~acc_1) & (theta_1 > theta0) & acc_s
        phis_bt, thetas_bt = phis_all[:, :n_grid], thetas_all[:, :n_grid]
        alphas_g = alphas_all[:, :n_grid]
        accepts_bt = acceptable(alphas_g, phis_bt, thetas_bt)[0] & ~is_rest
        bt_ok = accepts_bt.any(-1)
        first_idx = accepts_bt.to(torch.uint8).argmax(-1)
        alpha_bt = alphas_g.gather(1, first_idx[:, None])[:, 0]
        theta_bt = thetas_bt.gather(1, first_idx[:, None])[:, 0]

        # θ-only sufficient decrease for the restoration trials
        rel_a = alphas_g / torch.clamp(a_r, min=1e-30)[:, None]
        accepts_r = (
            is_rest
            & (thetas_bt <= (1.0 - opt.rest_theta_factor * rel_a) * theta0[:, None])
            & torch.isfinite(thetas_bt)
            & (theta0 > 10.0 * opt.tol)[:, None]
        )
        rest_ok = accepts_r.any(-1)
        rest_idx = accepts_r.to(torch.uint8).argmax(-1)
        alpha_rest = alphas_g.gather(1, rest_idx[:, None])[:, 0]
        theta_rest = thetas_bt.gather(1, rest_idx[:, None])[:, 0]
        use_rest = (~acc_1) & (~use_soc) & (~bt_ok) & rest_ok

        alpha = torch.where(acc_1, a_pri, torch.where(use_soc, a_soc, torch.where(
            bt_ok, alpha_bt, torch.where(rest_ok, alpha_rest, alpha_min))))
        step_dZ = torch.where(use_soc[:, None], dZ_soc, torch.where(use_rest[:, None], dZ_r, dZ))
        step_lam_plus = torch.where(
            use_rest[:, None], lam, torch.where(use_soc[:, None], lam_soc, lam_plus)
        )
        f_type_step = torch.where(acc_1, ftype_1, use_soc & ftype_s)

        # freeze the step once converged; restoration freezes the bound duals
        alpha = torch.where(stop_now, 0.0, alpha)
        a_dual = torch.where(stop_now | use_rest, 0.0, a_dual)

        # ---- update ------------------------------------------------------- #
        Z_new = nlp.apply_pins(Z + alpha[:, None] * step_dZ)
        s_new = s + alpha[:, None] * ds
        lam_new = lam + alpha[:, None] * (step_lam_plus - lam)
        nu_new = nu + a_dual[:, None] * dnu
        zL_new = zL + a_dual[:, None] * dzL
        zU_new = zU + a_dual[:, None] * dzU

        idx_sel = torch.where(use_soc, n_grid, torch.where(
            bt_ok, first_idx, torch.where(rest_ok, rest_idx, n_grid + 1)))
        c_e_sel = torch.where(acc_1[:, None], c_e_full, nlp.c_eq(Z_new))
        c_i_sel = torch.where(acc_1[:, None], c_i_full, nlp.c_in(Z_new))
        f_sel = torch.where(acc_1, f_full, fs_all.gather(1, idx_sel[:, None])[:, 0])

        # NaN guard: a lane whose step went non-finite freezes
        step_ok = (
            torch.isfinite(Z_new).all(-1) & torch.isfinite(s_new).all(-1)
            & torch.isfinite(lam_new).all(-1)
        )
        took_step = step_ok & (~stop_now)
        # oscillation watchdog: ratchet the μ-tied δ_w floor on lanes that
        # keep accepting only tiny backtracked steps
        small_step = took_step & (~use_rest) & (alpha < opt.osc_small_frac * a_pri)
        full_step = took_step & (~use_rest) & (alpha >= 0.9 * a_pri)
        osc_count = torch.where(
            small_step, torch.clamp(st.osc_count, min=0) + 1,
            torch.where(full_step, torch.clamp(st.osc_count, max=0) - 1, 0),
        ).to(i32)
        watchdog_on = opt.osc_watchdog_iter > 0
        osc_fire = (osc_count >= opt.osc_watchdog_iter) & watchdog_on
        osc_decay = (osc_count <= -opt.osc_watchdog_iter) & watchdog_on
        delta_w_boost = torch.where(
            osc_fire, torch.clamp(st.delta_w_boost * opt.osc_boost_factor, max=opt.osc_boost_cap),
            torch.where(osc_decay, torch.clamp(st.delta_w_boost / opt.osc_boost_factor, min=1.0),
                        st.delta_w_boost),
        )
        osc_count = torch.where(osc_fire | osc_decay, 0, osc_count).to(i32)
        c_e_new = torch.where(took_step[:, None], c_e_sel, c_e)
        c_i_new = torch.where(took_step[:, None], c_i_sel, c_i)
        okc = step_ok[:, None]
        Z_new = torch.where(okc, Z_new, Z)
        s_new = torch.where(okc, s_new, s)
        lam_new = torch.where(okc, lam_new, lam)
        nu_new = torch.where(okc, nu_new, nu)
        zL_new = torch.where(okc, zL_new, zL)
        zU_new = torch.where(okc, zU_new, zU)

        # dual safeguard (Ipopt κ_Σ clamp)
        dLn, dUn = bound_dists(Z_new)
        ks = opt.kappa_sigma
        zL_new = torch.where(mask_L, torch.clamp(zL_new, mu_c / (ks * dLn), ks * mu_c / dLn), 0.0)
        zU_new = torch.where(mask_U, torch.clamp(zU_new, mu_c / (ks * dUn), ks * mu_c / dUn), 0.0)

        z_max = torch.maximum(_amax0(Z_new.abs()), _amax0(s_new.abs()))
        diverged = st.diverged | (z_max > opt.diverging_iterates_tol)

        # ---- filter augmentation / clearing ------------------------------ #
        ls_collapse = (~acc_1) & (~use_soc) & (~bt_ok) & (~stop_now)
        collapse_clear = ls_collapse & (~use_rest)
        slot = filter_n % _FILTER_SIZE
        augment = (~f_type_step) & (~stop_now) & (~use_rest) & (~collapse_clear)
        hit = augment[:, None] & (torch.arange(_FILTER_SIZE, device=dev) == slot[:, None])
        filter_th = torch.where(hit, theta0[:, None], filter_th)
        filter_ph = torch.where(hit, phi0[:, None], filter_ph)
        filter_n = (filter_n + augment.to(i32)).to(i32)
        clear_f = use_rest | collapse_clear
        filter_th = torch.where(clear_f[:, None], inf, filter_th)
        filter_ph = torch.where(clear_f[:, None], inf, filter_ph)
        filter_n = torch.where(clear_f, 0, filter_n).to(i32)

        # ---- local-infeasibility certificate ------------------------------ #
        g_feas = free * ctx.JeT(c_e)
        g_proj = torch.where(
            (g_feas > 0) & mask_L, torch.minimum(g_feas, dL),
            torch.where((g_feas < 0) & mask_U, torch.maximum(g_feas, -dU), g_feas),
        )
        feas_stationary = _amax0(g_proj.abs()) <= opt.inf_du_tol * torch.clamp(theta0, min=1.0)
        theta_sel = torch.where(acc_1, theta_1, torch.where(use_soc, theta_s, torch.where(
            bt_ok, theta_bt, torch.where(rest_ok, theta_rest, theta0))))
        stalled = ls_collapse & (theta_sel > opt.rest_stall_kappa * theta0)
        made_progress = theta_sel <= 0.9 * theta0
        stall_count = torch.where(
            stalled, st.stall_count + 1, torch.where(made_progress, 0, st.stall_count)
        ).to(i32)
        theta_big = theta0 > max(opt.constr_viol_tol, 10.0 * opt.tol)
        far_from_opt = e_0 > 1e2 * max(opt.acceptable_tol, opt.tol)
        infeasible = st.infeasible | (
            (stall_count >= options.infeasibility_iter) & theta_big & feas_stationary & far_from_opt
        )
        rest_failed = st.rest_failed | (
            (stall_count >= 2 * options.infeasibility_iter) & theta_big & far_from_opt
        )

        return IPMState(
            Z=Z_new, s=s_new, lam=lam_new, nu=nu_new, zL=zL_new, zU=zU_new, mu=mu,
            theta_max=st.theta_max, theta_min=st.theta_min,
            filter_th=filter_th, filter_ph=filter_ph, filter_n=filter_n,
            c_e=c_e_new, c_i=c_i_new,
            delta_w_last=torch.where(delta_fin > 0, delta_fin, st.delta_w_last),
            stall_count=stall_count, infeasible=infeasible, rest_failed=rest_failed,
            diverged=diverged,
            iter=(st.iter + (~stop_now).to(i32)).to(i32),
            converged=conv_now, acc_count=acc_count, err=e_0,
            obj=torch.where(took_step, f_sel, st.obj),
            best_kkt=best_kkt, best_kkt_ok=best_kkt_ok, best_kkt_Z=best_kkt_Z,
            best_kkt_obj=best_kkt_obj, best_kkt_warm=best_kkt_warm,
            obj_prev=st.obj, osc_count=osc_count, delta_w_boost=delta_w_boost,
        )

    def cond(st: IPMState) -> torch.Tensor:
        return (
            (~st.converged) & (~st.infeasible) & (~st.rest_failed) & (~st.diverged)
            & (st.acc_count < options.acceptable_iter) & (st.iter < options.max_iter)
        )

    st = state0
    active = cond(st)
    while bool(active.any()):
        st = tree_where(active, body(st, active), st)
        active = cond(st)

    opt_hit = (st.best_kkt <= opt.tol) & st.best_kkt_ok
    acc_hit = st.best_kkt <= opt.acceptable_tol
    status = torch.where(opt_hit, 0, torch.where(acc_hit, 1, torch.where(
        st.infeasible, 4, torch.where(st.rest_failed, 5, torch.where(st.diverged, 6, 2))))).to(i32)
    return IPMResult(
        Z=st.best_kkt_Z, state=st, iterations=st.iter, converged=opt_hit | acc_hit,
        status=status, kkt_error=st.best_kkt, objective=st.best_kkt_obj,
    )
