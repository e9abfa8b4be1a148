"""Batched primal-dual interior-point method.

Counterpart of ``directtrajopt_tpu/solvers/ipm.py`` (Wächter–Biegler filter
IPM): log barrier for box bounds and for the slacks s of inequality rows
(duals ν, condensed as D = ν/s), condensed KKT through the Riccati
backend with δ_w inertia control, fraction-to-boundary, a filter line
search whose backtracking grid, second-order correction (SOC) and
restoration slots are evaluated as one batched trial pass, the monotone
barrier schedule, acceptable-level termination, the μ-tied proximal δ_w
floor, the oscillation watchdog and the error-free transforms of
``compensated_residuals``. The options of the JAX package's IPM are all
here: the monotone, Mehrotra (affine-scaling probe) and adaptive (LOQO
centrality) barrier rules, a non-monotone line search (``ls_memory``),
least-squares initial equality duals, float64 residual refinement inside a
float32 solve (``refine_residuals``: the residuals, the right-hand side and
the accepting trial in float64, the multipliers by increments), and compact
L-BFGS, whose (s, y) rings ride the state and whose model reaches the
Riccati backend in compact form by ``set_lbfgs`` and the dense backend
materialized by ``set_hessian``.

The JAX package ``vmap``s a per-problem ``while_loop``. Here the loop is
written batch-first: every state field carries a leading lane axis, the
body runs on all lanes, and ``torch.where`` keeps each lane whose loop
predicate is false frozen — exactly the semantics of a vmapped while loop,
so per-lane iteration counts match the JAX solve.

Callbacks (``solvers/callbacks.py``) hook into each lockstep iteration:
host monitoring, stop predicates per lane, a host-interactive stop, the
iterate and telemetry rings and best-score tracking. A hook that is not set
runs no device operation.

Every option of the JAX package's ``IPMOptions`` is ported.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch
from torch.func import vjp

from ..module import tree_map, tree_where
from ..precision import lane_sum
from ..utils.profiling import span
from .assembly import gradient
from .callbacks import IPMCallbacks, _wall_stop_cached
from .canonical import CanonicalNLP
from .options import IPMOptions

__all__ = ["IPMState", "IPMResult", "WarmStart", "TELEMETRY_COLUMNS", "ipm_solve"]

_BIG = 1e20
_FILTER_SIZE = 64
_GAMMA_THETA = 1e-5
_GAMMA_PHI = 1e-8
_S_THETA = 1.1
_S_PHI = 2.3


def _lbfgs_compact(S, Y, count, sigma_clip=(1e-6, 1e6)):
    """Byrd–Nocedal–Schnabel compact L-BFGS factors ``(σ, U, M)`` per lane
    with ``B = σI − Uᵀ M⁻¹ U``, ``U = [σS; Y]`` (B, 2m, z) and
    ``M = [[σSᵀS, L], [Lᵀ, −D]]``, L the strictly lower part of SYᵀ and
    D = diag(SYᵀ) (the JAX package's ``_lbfgs_compact``). ``S``, ``Y``
    (B, m, z) are rings with the newest pair last and ``count`` (B,) live
    pairs; the older slots are masked out and their diagonal of M padded
    with 1, which leaves B unchanged. σ = yᵀy / sᵀy of the newest pair,
    clipped; 1 with no pair."""
    m = S.shape[1]
    dtype = S.dtype
    valid = (torch.arange(m, device=S.device) >= m - count[:, None]).to(dtype)
    Sv = S * valid[..., None]
    Yv = Y * valid[..., None]
    sy_last = lane_sum(S[:, -1] * Y[:, -1])
    yy_last = lane_sum(Y[:, -1] * Y[:, -1])
    sigma = torch.where(count > 0, yy_last / torch.clamp(sy_last, min=1e-30), 1.0)
    sigma = torch.clamp(sigma, *sigma_clip)
    SS = Sv @ Sv.transpose(-1, -2)
    SY = Sv @ Yv.transpose(-1, -2)
    Lo = torch.tril(SY, -1)
    M = torch.cat([torch.cat([sigma[:, None, None] * SS, Lo], dim=-1),
                   torch.cat([Lo.transpose(-1, -2), -torch.diag_embed(torch.diagonal(
                       SY, dim1=-2, dim2=-1))], dim=-1)], dim=-2)
    M = M + torch.diag_embed(torch.cat([1.0 - valid, 1.0 - valid], dim=-1))
    U = torch.cat([sigma[:, None, None] * Sv, Yv], dim=1)
    return sigma, U, M


def _lbfgs_hessian(S, Y, count, sigma_clip=(1e-6, 1e6)):
    """The compact L-BFGS Hessian ``σI − UᵀM⁻¹U`` materialized dense per lane,
    (B, z, z) (see :func:`_lbfgs_compact`; the dense backend's model)."""
    sigma, U, M = _lbfgs_compact(S, Y, count, sigma_clip)
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    return sigma[:, None, None] * eye - U.transpose(-1, -2) @ torch.linalg.solve(M, U)


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
    stopped: torch.Tensor  # a callback asked the lane to stop
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
    history_Z: torch.Tensor  # (B, K, z_dim) iterate ring (K may be 0)
    hist_n: torch.Tensor
    history_stats: torch.Tensor  # (B, T, 8) telemetry ring (T may be 0)
    best_score: torch.Tensor
    best_Z: torch.Tensor
    # (B, K) / (B, K, z_dim) top-K score retention (score_top_k > 1 only)
    topk_scores: torch.Tensor | None = None
    topk_Z: torch.Tensor | None = None
    # (B, ls_memory) recent φ ring of the non-monotone line search
    # (ls_memory > 1 only)
    phi_hist: torch.Tensor | None = None
    # L-BFGS only: the (B, m, z_dim) curvature-pair rings (newest pair
    # last), the live-pair count, and the previous iterate and Lagrangian
    # gradient that complete the next pair
    lbfgs_S: torch.Tensor | None = None
    lbfgs_Y: torch.Tensor | None = None
    lbfgs_n: torch.Tensor | None = None
    lbfgs_g_prev: torch.Tensor | None = None
    lbfgs_Z_prev: torch.Tensor | None = None


class IPMResult(NamedTuple):
    Z: torch.Tensor
    state: IPMState
    iterations: torch.Tensor
    converged: torch.Tensor
    status: torch.Tensor  # 0 optimal, 1 acceptable, 2 iteration limit,
    # 3 stopped by a callback, 4 locally infeasible, 5 restoration failed,
    # 6 diverging iterates
    kkt_error: torch.Tensor
    objective: torch.Tensor
    history_Z: torch.Tensor
    best_Z: torch.Tensor
    best_score: torch.Tensor
    history_stats: torch.Tensor  # (B, T, 8) telemetry ring, columns TELEMETRY_COLUMNS
    topk_scores: torch.Tensor | None = None
    topk_Z: torch.Tensor | None = None


# columns of IPMResult.history_stats: one row per iteration (a ring of
# IPMCallbacks.telemetry_size rows), written before the step, so row i
# describes iterate i
TELEMETRY_COLUMNS = (
    "objective",
    "inf_pr",
    "inf_du",
    "mu",
    "kkt_error",
    "alpha",
    "delta_w",
    "theta",
)


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


def _print_iteration(**fields) -> None:
    """The ``print_level >= 5`` line: one per lockstep iteration, each field
    a (B,) tensor printed over the lanes."""

    def fmt(t, spec):
        return "[" + " ".join(format(v, spec) for v in t.tolist()) + "]"

    with span("host.sync"):
        line = " ".join(f"{k}={fmt(t, spec)}" for k, (t, spec) in fields.items())
    print(line, flush=True)


def _ring_set(ring: torch.Tensor, slot: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``ring`` (B, K, ·) with row ``slot`` (B,) of each lane set to ``row`` (B, ·)."""
    idx = slot.long()[:, None, None].expand(-1, 1, ring.shape[-1])
    return ring.scatter(1, idx, row[:, None].to(ring.dtype))


def ipm_solve(nlp: CanonicalNLP, Z0: torch.Tensor, options: IPMOptions, ops=None,
              callbacks: IPMCallbacks | None = None,
              warm: WarmStart | None = None) -> IPMResult:
    """Run the interior-point method from ``Z0`` (B, z_dim) on every lane.

    ``callbacks``: an optional :class:`IPMCallbacks` (host monitoring, stop
    predicates, rings, best-score tracking). ``options.max_wall_time`` > 0
    adds a wall-clock stop anchored at this solve's start. ``ops`` None
    means the dense backend."""
    options.check_supported()
    if ops is None:
        from .ops_dense import DenseOps

        ops = DenseOps(nlp)
    cb = callbacks
    if options.max_wall_time > 0.0:
        cb = _wall_stop_cached(float(options.max_wall_time)).merged_with(cb)
    hist_k = cb.history_size if cb else 0
    tele_k = cb.telemetry_size if cb else 0
    top_k = cb.score_top_k if cb is not None and cb.score_fn is not None else 1
    dtype, dev = Z0.dtype, Z0.device
    B = Z0.shape[0]
    # float64 residual refinement inside a float32 solve; a no-op in float64
    hi = bool(options.refine_residuals) and dtype == torch.float32
    # compensated float32 arithmetic; refinement supersedes it
    comp = bool(options.compensated_residuals) and dtype == torch.float32 and not hi
    f64 = torch.float64
    # the problem in float64 (its float32 data widened exactly), for the
    # refined residuals
    nlp64 = (tree_map(lambda x: x.to(f64) if x.is_floating_point() else x, nlp)
             if hi else None)
    opt = options.astype(dtype)
    mu_floor = max(opt.mu_min, opt.tol / 10.0)
    z_dim, n_eq, n_in = nlp.z_dim, nlp.n_eq, nlp.n_in
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
    with span("ipm.init"):
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
        theta_init = lane_sum(c_e0.abs()) + lane_sum((c_i0 + s_init).abs())
        gn = options.hessian_approximation == "gauss_newton"
        sw = (options.hessian_regularization
              if options.hessian_regularization in ("stagewise", "project", "flip", "floor")
              else False)
        lbfgs = options.hessian_approximation == "lbfgs"
        m_l = options.limited_memory_max_history if lbfgs else 0
        n_hist = options.ls_memory if options.ls_memory > 1 else 0
        mehrotra = options.mu_strategy == "mehrotra"
        obj0 = nlp.objective(Z_init)
        i32 = torch.int32
        if warm is None and options.dual_init == "least_squares" and n_eq:
            # least-squares equality multipliers: one KKT solve at the start
            # point (μ = 0 right-hand side), kept where its factorization is
            # certified and ‖λ‖∞ ≤ lam_init_max
            with span("ipm.prepare"):
                ctx0 = ops.prepare(Z_init, lam0, nu0, cache=(c_e0, c_i0), gauss_newton=gn,
                                   stagewise=sw, skip_hessian=lbfgs)
                if lbfgs and hasattr(ctx0, "set_lbfgs"):  # B₀ = I is the natural metric here
                    ctx0.set_lbfgs(full(1.0), Z_init.new_zeros((B, 2 * m_l, z_dim)),
                                   torch.eye(2 * m_l, dtype=dtype, device=dev).expand(B, -1, -1))
                elif lbfgs:
                    ctx0.set_hessian(torch.eye(z_dim, dtype=dtype, device=dev).expand(B, -1, -1))
            Sig0 = (torch.where(mask_L, zL0 / dL0, 0.0)
                    + torch.where(mask_U, zU0 / dU0, 0.0)) * free
            g0 = free * ctx0.grad_f
            with span("ipm.kkt"):
                _, lam_ls, ok0, _, _ = ctx0.kkt_step(Sig0, nu0 / s_init, g0, torch.zeros_like(c_e0),
                                                     full(0.0), opt)
            good = ok0 & (_amax0(lam_ls.abs()) <= opt.lam_init_max)
            lam0 = torch.where(good[:, None], lam_ls, 0.0)

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
            stopped=full(False, torch.bool),
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
            history_Z=Z_init.new_zeros((B, hist_k, z_dim)),
            hist_n=full(0, i32),
            history_stats=Z_init.new_zeros((B, tele_k, 8)),
            best_score=full(-inf),
            best_Z=Z_init,
            topk_scores=(torch.full((B, top_k), -inf, dtype=dtype, device=dev)
                         if top_k > 1 else None),
            topk_Z=Z_init.new_zeros((B, top_k, z_dim)) if top_k > 1 else None,
            phi_hist=(torch.full((B, n_hist), -inf, dtype=dtype, device=dev) if n_hist else None),
            lbfgs_S=Z_init.new_zeros((B, m_l, z_dim)) if lbfgs else None,
            lbfgs_Y=Z_init.new_zeros((B, m_l, z_dim)) if lbfgs else None,
            lbfgs_n=full(0, i32) if lbfgs else None,
            lbfgs_g_prev=Z_init.new_zeros((B, z_dim)) if lbfgs else None,
            lbfgs_Z_prev=Z_init if lbfgs else None,
        )
    s_max = 100.0

    def _bar(Z, s):
        dL, dU = bound_dists(Z)
        return (
            lane_sum(torch.where(_lane(mask_L, Z), torch.log(dL), 0.0))
            + lane_sum(torch.where(_lane(mask_U, Z), torch.log(dU), 0.0))
            + lane_sum(torch.log(s))
        )

    def barrier_phi_from(f, Z, s, mu, c_e, c_i):
        theta = lane_sum(c_e.abs()) + lane_sum((c_i + s).abs())
        return f - _lane(mu, f) * _bar(Z, s), theta

    def body(st: IPMState, active: torch.Tensor) -> IPMState:
        Z, s, lam, nu, zL, zU = st.Z, st.s, st.lam, st.nu, st.zL, st.zU
        with span("ipm.prepare"):
            dL, dU = bound_dists(Z)
            ctx = ops.prepare(Z, lam, nu, cache=(st.c_e, st.c_i), gauss_newton=gn, stagewise=sw,
                              skip_hessian=lbfgs)
            gf, c_e, c_i = ctx.grad_f, ctx.c_e, ctx.c_i

            lbfgs_S, lbfgs_Y, lbfgs_n = st.lbfgs_S, st.lbfgs_Y, st.lbfgs_n
            if lbfgs:
                # complete the (s, y) pair begun at the end of the previous
                # iteration: y = ∇L(Z; λ, ν) − ∇L(Z_prev; λ, ν) at the same
                # multipliers (carried in lbfgs_g_prev)
                s_pair = Z - st.lbfgs_Z_prev
                y_pair = ctx.grad_f + ctx.JeT(lam) + ctx.JiT(nu) - st.lbfgs_g_prev
                sy = lane_sum(s_pair * y_pair)
                ss = lane_sum(s_pair * s_pair)
                yy = lane_sum(y_pair * y_pair)
                # curvature condition (skip the update where it fails)
                good = ((st.iter > 0) & (sy > 1e-8 * torch.sqrt(ss * yy)) & torch.isfinite(sy)
                        & (ss > 0))
                gc = good[:, None, None]
                lbfgs_S = torch.where(gc, torch.cat([st.lbfgs_S[:, 1:], s_pair[:, None]], 1),
                                      st.lbfgs_S)
                lbfgs_Y = torch.where(gc, torch.cat([st.lbfgs_Y[:, 1:], y_pair[:, None]], 1),
                                      st.lbfgs_Y)
                lbfgs_n = torch.clamp(st.lbfgs_n + good.to(i32), max=m_l).to(i32)
                if hasattr(ctx, "set_lbfgs"):
                    # σI in the stage blocks, the low-rank part by SMW through
                    # the O(N) factorization (no densification)
                    ctx.set_lbfgs(*_lbfgs_compact(lbfgs_S, lbfgs_Y, lbfgs_n))
                else:
                    ctx.set_hessian(_lbfgs_hessian(lbfgs_S, lbfgs_Y, lbfgs_n))

            if hi:
                # the float64 residual bundle: every quantity below is small near
                # the solution only because O(1) terms cancel, so the
                # cancellation runs in float64 and the small result is cast back
                Z64 = Z.to(f64)
                gf64 = gradient(nlp64, Z64)
                c_e64, vjp_e = vjp(nlp64.c_eq, Z64)
                c_i64, vjp_i = vjp(nlp64.c_in, Z64)
                free64 = free.to(f64)
                JeTlam64 = free64 * vjp_e(lam.to(f64))[0] if n_eq else torch.zeros_like(Z64)
                gf, c_e, c_i = gf64.to(dtype), c_e64.to(dtype), c_i64.to(dtype)

        # ---- optimality errors at the current iterate -------------------- #
        with span("ipm.direction"):
            if hi:
                JiTnu64 = vjp_i(nu.to(f64))[0] if n_in else torch.zeros_like(Z64)
                r_dual = (free64 * (gf64 + JeTlam64 + JiTnu64 - zL.to(f64) + zU.to(f64))).to(dtype)
            elif comp:
                # five O(1) terms cancelling to O(tol): compensated summation
                r_dual = free * _csum([gf, ctx.JeT(lam), ctx.JiT(nu), -zL, zU])
            else:
                r_dual = free * (gf + ctx.JeT(lam) + ctx.JiT(nu) - zL + zU)
            z_sum = lane_sum(lam.abs()) + lane_sum(nu.abs())
            b_sum = lane_sum(zL.abs()) + lane_sum(zU.abs())
            n_tot = max(1, n_eq + n_in + 2 * z_dim)
            s_d = torch.clamp((z_sum + b_sum) / n_tot, min=s_max) / s_max
            s_c = torch.clamp(b_sum / max(1, 2 * z_dim), min=s_max) / s_max
            inf_du = _amax0(r_dual.abs())
            inf_pr = torch.maximum(_amax0(c_e.abs()), _amax0((c_i + s).abs()))

            if hi:
                # complementarity products in float64 (d·z ≈ μ only by
                # cancellation of the float32 rounding of d near an active bound)
                dLc = torch.where(_lane(has_L, Z64), Z64 - _lane(lb, Z64).to(f64), 1.0)
                dUc = torch.where(_lane(has_U, Z64), _lane(ub, Z64).to(f64) - Z64, 1.0)
                zLc, zUc, sc_, nuc = zL.to(f64), zU.to(f64), s.to(f64), nu.to(f64)
            else:
                dLc, dUc, zLc, zUc, sc_, nuc = dL, dU, zL, zU, s, nu

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
                    comp_L = torch.where(mask_L, dLc * zLc - mu_val, 0.0)
                    comp_U = torch.where(mask_U, dUc * zUc - mu_val, 0.0)
                    comp_s = sc_ * nuc - mu_val
                return torch.maximum(
                    torch.maximum(_amax0(comp_L.abs()), _amax0(comp_U.abs())),
                    _amax0(comp_s.abs()),
                ).to(dtype)

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

            # ---- barrier update (+ filter reset) ------------------------------ #
            filter_th, filter_ph, filter_n = st.filter_th, st.filter_ph, st.filter_n
            if mehrotra:
                # μ is chosen after the affine-scaling probe below
                mu = st.mu
                mu_update = torch.zeros_like(st.converged)
            elif options.mu_strategy == "adaptive":
                # LOQO-style centrality rule: μ = σ·(average complementarity),
                # σ driven by how uncentred the complementarity pairs are
                nan = float("nan")
                comp_terms = torch.cat([torch.where(mask_L, dL * zL, nan),
                                        torch.where(mask_U, dU * zU, nan), s * nu], dim=-1)
                m_cnt = (~torch.isnan(comp_terms)).sum(-1)
                avg_c = lane_sum(comp_terms, nan=True) / torch.clamp(m_cnt, min=1)
                min_c = (torch.where(torch.isnan(comp_terms), inf, comp_terms).amin(-1)
                         if comp_terms.shape[-1] else full(inf))
                has_comp = m_cnt > 0
                xi = torch.where(has_comp, min_c / torch.clamp(avg_c, min=1e-30), 1.0)
                sigma = 0.1 * torch.clamp(0.05 * (1.0 - xi) / torch.clamp(xi, min=1e-6),
                                          max=2.0) ** 3
                mu_target = torch.clamp(sigma * avg_c, min=mu_floor, max=opt.mu_init)
                mu = torch.where(has_comp, mu_target, torch.clamp(0.2 * st.mu, min=mu_floor))
                # reset the filter only on large barrier drops
                mu_update = mu <= 0.1 * st.mu
            else:
                # two-regime monotone (Fiacco–McCormick) rule
                switch_level = opt.mu_switch_factor * opt.tol
                endgame = st.mu <= switch_level
                k_eps_far = (opt.kappa_epsilon_far if opt.kappa_epsilon_far > 0
                             else opt.kappa_epsilon)
                k_mu_far = opt.kappa_mu_far if opt.kappa_mu_far > 0 else opt.kappa_mu
                k_eps = torch.where(endgame, full(opt.kappa_epsilon), full(k_eps_far))
                k_mu = torch.where(endgame, full(opt.kappa_mu), full(k_mu_far))
                mu_update = e_mu <= k_eps * st.mu
                mu_raw = torch.clamp(torch.minimum(k_mu * st.mu, st.mu ** opt.theta_mu),
                                     min=mu_floor)
                mu_raw = torch.where(endgame, mu_raw, torch.clamp(mu_raw, min=switch_level))
                mu = torch.where(mu_update, mu_raw, st.mu)
            if not mehrotra:
                filter_th = torch.where(mu_update[:, None], inf, st.filter_th)
                filter_ph = torch.where(mu_update[:, None], inf, st.filter_ph)
                filter_n = torch.where(mu_update, 0, st.filter_n).to(i32)
            # the non-monotone memory compares φ within one barrier value only
            phi_hist = st.phi_hist
            if n_hist:
                phi_hist = torch.where(mu_update[:, None], -inf, st.phi_hist)

            # ---- condensed system ------------------------------------------- #
            SigL = torch.where(mask_L, zL / dL, 0.0)
            SigU = torch.where(mask_U, zU / dU, 0.0)
            Sig = (SigL + SigU) * free
            D = nu / s
            # per-iteration proximal δ_w floor with the lane's watchdog boost
            opt_k = opt.replace(
                delta_w_min=torch.clamp(opt.delta_w_mu_scale * mu * st.delta_w_boost,
                                        min=opt.delta_w_min)
            )

            def build_g_hat(mu_v):
                """The condensed right-hand side at barrier value ``mu_v`` (B,).
                Refined, it is evaluated in float64 and shifted by the float64
                Jᵀλ: the shifted right-hand side is the barrier dual residual
                (small near the solution), so the cast keeps its relative
                precision and the solve returns the increment Δλ, not λ⁺."""
                if hi:
                    mu64 = mu_v.to(f64)[:, None]
                    g = (gf64 - torch.where(mask_L, mu64 / dLc, 0.0)
                         + torch.where(mask_U, mu64 / dUc, 0.0))
                    if n_in:
                        g = g + vjp_i(mu64 / sc_ + (nuc / sc_) * (c_i64 + sc_))[0]
                    return (free64 * (g + JeTlam64)).to(dtype)
                mu_v = mu_v[:, None]
                g = gf - torch.where(mask_L, mu_v / dL, 0.0) + torch.where(mask_U, mu_v / dU, 0.0)
                if n_in:
                    g = g + ctx.JiT(mu_v / s + D * (c_i + s))
                return free * g

            if mehrotra:
                # ---- affine-scaling probe: factor once, solve the μ = 0 system,
                # measure the complementarity it would reach and take
                # μ = σ·(average complementarity) with σ = (μ_aff/μ_avg)³ ------ #
                g_aff = gf
                if n_in:
                    g_aff = g_aff + ctx.JiT(D * (c_i + s))
                with span("ipm.kkt"):
                    dZ_a, _, ok, delta_fin, resolve = ctx.kkt_step(
                        Sig, D, free * g_aff, -c_e, st.delta_w_last, opt_k, active)
                ds_a = -(c_i + s) - ctx.Ji(dZ_a)
                dnu_a = -nu - D * ds_a
                dzL_a = torch.where(mask_L, -zL - SigL * dZ_a, 0.0)
                dzU_a = torch.where(mask_U, -zU + SigU * dZ_a, 0.0)
                tau_a = 0.995
                ap = torch.minimum(
                    _masked_min(-tau_a * dL / torch.clamp(dZ_a, max=-1e-30), mask_L & (dZ_a < 0),
                                1.0),
                    _masked_min(tau_a * dU / torch.clamp(dZ_a, min=1e-30), mask_U & (dZ_a > 0),
                                1.0),
                )
                ad = torch.minimum(
                    _masked_min(-tau_a * zL / torch.clamp(dzL_a, max=-1e-30), mask_L & (dzL_a < 0),
                                1.0),
                    _masked_min(-tau_a * zU / torch.clamp(dzU_a, max=-1e-30), mask_U & (dzU_a < 0),
                                1.0),
                )
                if n_in:
                    ap = torch.minimum(ap, _masked_min(
                        -tau_a * s / torch.clamp(ds_a, max=-1e-30), ds_a < 0, 1.0))
                    ad = torch.minimum(ad, _masked_min(
                        -tau_a * nu / torch.clamp(dnu_a, max=-1e-30), dnu_a < 0, 1.0))
                apc, adc = ap[:, None], ad[:, None]
                comp_now = (lane_sum(torch.where(mask_L, dL * zL, 0.0))
                            + lane_sum(torch.where(mask_U, dU * zU, 0.0)) + lane_sum(s * nu))
                comp_aff = (
                    lane_sum(torch.where(mask_L, (dL + apc * dZ_a) * (zL + adc * dzL_a), 0.0))
                    + lane_sum(torch.where(mask_U, (dU - apc * dZ_a) * (zU + adc * dzU_a), 0.0))
                    + lane_sum((s + apc * ds_a) * (nu + adc * dnu_a))
                )
                m_cnt = (mask_L.sum(-1) + mask_U.sum(-1) + n_in).to(dtype).expand(B)
                mu_avg = comp_now / torch.clamp(m_cnt, min=1.0)
                mu_aff = comp_aff / torch.clamp(m_cnt, min=1.0)
                sigma = torch.clamp((mu_aff / torch.clamp(mu_avg, min=1e-30)) ** 3, 1e-4, 10.0)
                mu_new = torch.clamp(sigma * mu_avg, min=mu_floor, max=opt.mu_init)
                mu = torch.where(m_cnt > 0, mu_new, torch.clamp(0.2 * mu, min=mu_floor))
                # filter reset on large barrier drops
                mu_update = mu <= 0.1 * st.mu
                filter_th = torch.where(mu_update[:, None], inf, filter_th)
                filter_ph = torch.where(mu_update[:, None], inf, filter_ph)
                filter_n = torch.where(mu_update, 0, filter_n).to(i32)
                if n_hist:
                    phi_hist = torch.where(mu_update[:, None], -inf, phi_hist)
                g_hat = build_g_hat(mu)
                dZ, lam_plus = resolve(-g_hat, -c_e)
            else:
                g_hat = build_g_hat(mu)
                with span("ipm.kkt"):
                    dZ, lam_plus, ok, delta_fin, resolve = ctx.kkt_step(
                        Sig, D, g_hat, -c_e, st.delta_w_last, opt_k, active
                    )
            if hi:
                # the Jᵀλ shift makes the solver's multiplier the increment Δλ
                lam_plus = lam + lam_plus
            mu_c = mu[:, None]

            # ---- recover eliminated directions ------------------------------- #
            ds = -(c_i + s) - ctx.Ji(dZ)
            dnu = mu_c / s - nu - D * ds
            dzL = torch.where(mask_L, mu_c / dL - zL - SigL * dZ, 0.0)
            dzU = torch.where(mask_U, mu_c / dU - zU + SigU * dZ, 0.0)

            # ---- fraction-to-boundary step sizes ----------------------------- #
            tau = torch.clamp(1.0 - mu, min=opt.tau_min)[:, None]

            def max_primal_step(dZ_, ds_):
                a = torch.minimum(
                    _masked_min(-tau * dL / torch.clamp(dZ_, max=-1e-30), mask_L & (dZ_ < 0), 1.0),
                    _masked_min(tau * dU / torch.clamp(dZ_, min=1e-30), mask_U & (dZ_ > 0), 1.0),
                )
                if n_in:
                    a = torch.minimum(
                        a, _masked_min(-tau * s / torch.clamp(ds_, max=-1e-30), ds_ < 0, 1.0))
                return a

            a_pri = max_primal_step(dZ, ds)
            a_dual = torch.minimum(
                _masked_min(-tau * zL / torch.clamp(dzL, max=-1e-30), mask_L & (dzL < 0), 1.0),
                _masked_min(-tau * zU / torch.clamp(dzU, max=-1e-30), mask_U & (dzU < 0), 1.0),
            )
            if n_in:
                a_dual = torch.minimum(
                    a_dual, _masked_min(-tau * nu / torch.clamp(dnu, max=-1e-30), dnu < 0, 1.0))

        # ---- filter line search with second-order correction ------------- #
        with span("ipm.line_search"):
            phi0, theta0 = barrier_phi_from(st.obj, Z, s, mu, c_e, c_i)
            Dphi = (
                lane_sum(gf * dZ)
                - mu * lane_sum(torch.where(mask_L, dZ / dL, 0.0))
                + mu * lane_sum(torch.where(mask_U, dZ / dU, 0.0))
            )
            if n_in:
                Dphi = Dphi - mu * lane_sum(ds / s)
            # non-monotone reference (Grippo): the largest φ of the recent
            # iterates at this μ; ls_memory = 1 is the monotone test
            phi_ref = torch.maximum(phi0, phi_hist.amax(-1)) if n_hist else phi0

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
            if hi:
                # near the floor the accepting (usually full) step's θ/φ decrease
                # is below float32 evaluation noise: judge it on float64
                # residuals (the backtracking grid stays float32)
                Zf64 = Z_full.to(f64)
                c_e_full = nlp64.c_eq(Zf64).to(dtype)
                c_i_full = nlp64.c_in(Zf64).to(dtype)
                f_full = nlp64.objective(Zf64).to(dtype)
            else:
                c_e_full = nlp.c_eq(Z_full)
                c_i_full = nlp.c_in(Z_full)
                f_full = nlp.objective(Z_full)
            phi_1, theta_1 = barrier_phi_from(f_full, Z_full, s_full, mu, c_e_full, c_i_full)
            acc_1, ftype_1 = acceptable(a_pri, phi_1, theta_1)

            a_c = a_pri[:, None]
            c_soc = a_c * c_e + c_e_full
            ci_soc = a_c * (c_i + s) + c_i_full + s_full
            g_soc = free * ctx.JiT(D * ci_soc) if n_in else torch.zeros_like(Z)
            n_rest = options.n_rest_trials if (n_eq or n_in) else 0
            soc_on = options.max_soc > 0
            rest_rhs = []
            if soc_on:
                rest_rhs.append((-g_hat - g_soc, -c_soc))
            if n_rest:
                g_rest = free * ctx.JiT(D * (c_i + s)) if n_in else torch.zeros_like(Z)
                rest_rhs.append((-g_rest, -c_e))
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
            if hi and soc_on:
                # the SOC's right-hand side carries the Jᵀλ shift too
                lam_soc = lam + lam_soc
            ds_soc = -ci_soc - ctx.Ji(dZ_soc)
            a_soc = max_primal_step(dZ_soc, ds_soc) if soc_on else full(0.0)
            if n_rest:
                ds_r = -(c_i + s) - ctx.Ji(dZ_r)
                a_r = max_primal_step(dZ_r, ds_r)
            else:
                dZ_r, ds_r = dZ, ds
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
            ds_trials = torch.stack([ds, ds_r, ds_soc], dim=1)[:, dir_idx]
            st_ = s[:, None] + alphas_all[..., None] * ds_trials
            c_i_t = nlp.c_in(Zt)
            fs_all = nlp.objective(Zt)
            # θ via the fused Σ|c_eq| path (the L1 form of the residual kernel)
            thetas_all = nlp.c_eq_l1(Zt) + lane_sum((c_i_t + st_).abs())
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
            step_dZ = torch.where(use_soc[:, None], dZ_soc,
                                  torch.where(use_rest[:, None], dZ_r, dZ))
            step_ds = torch.where(use_soc[:, None], ds_soc,
                                  torch.where(use_rest[:, None], ds_r, ds))
            step_lam_plus = torch.where(
                use_rest[:, None], lam, torch.where(use_soc[:, None], lam_soc, lam_plus)
            )
            f_type_step = torch.where(acc_1, ftype_1, use_soc & ftype_s)

            # freeze the step once converged; restoration freezes the bound duals
            alpha = torch.where(stop_now, 0.0, alpha)
            a_dual = torch.where(stop_now | use_rest, 0.0, a_dual)

        # ---- update ------------------------------------------------------- #
        with span("ipm.update"):
            Z_new = nlp.apply_pins(Z + alpha[:, None] * step_dZ)
            s_new = s + alpha[:, None] * step_ds
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
                osc_fire,
                torch.clamp(st.delta_w_boost * opt.osc_boost_factor, max=opt.osc_boost_cap),
                torch.where(osc_decay,
                            torch.clamp(st.delta_w_boost / opt.osc_boost_factor, min=1.0),
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
            zL_new = torch.where(mask_L, torch.clamp(zL_new, mu_c / (ks * dLn), ks * mu_c / dLn),
                                 0.0)
            zU_new = torch.where(mask_U, torch.clamp(zU_new, mu_c / (ks * dUn), ks * mu_c / dUn),
                                 0.0)
            if n_in:
                nu_new = torch.clamp(nu_new, mu_c / (ks * s_new), ks * mu_c / s_new)

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
            if n_hist:
                # push this iterate's φ into the non-monotone window (cleared by
                # a restoration step or a collapse, as the filter is)
                hit_h = (~stop_now)[:, None] & (
                    torch.arange(n_hist, device=dev) == (st.iter % n_hist)[:, None])
                phi_hist = torch.where(hit_h, phi0[:, None], phi_hist)
                phi_hist = torch.where(clear_f[:, None], -inf, phi_hist)

            # ---- local-infeasibility certificate ------------------------------ #
            g_feas = free * ctx.JeT(c_e)
            if n_in:
                g_feas = g_feas + free * ctx.JiT(c_i + s)
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
                (stall_count >= options.infeasibility_iter) & theta_big & feas_stationary
                & far_from_opt
            )
            rest_failed = st.rest_failed | (
                (stall_count >= 2 * options.infeasibility_iter) & theta_big & far_from_opt
            )

            if options.print_level >= 5:
                _print_iteration(it=(st.iter, "d"), mu=(mu, ".1e"), obj=(st.obj, ".6f"),
                                 th=(theta0, ".2e"), e0=(e_0, ".2e"), emu=(e_mu, ".2e"),
                                 a=(alpha, ".2e"), amax=(a_pri, ".2e"), soc=(use_soc, ""),
                                 dw=(delta_fin, ".1e"), ok=(ok, ""))

            # ---- user callbacks ---------------------------------------------- #
            obj_new = torch.where(took_step, f_sel, st.obj)
            stopped = st.stopped
            if cb is not None and (cb.host_fn is not None or cb.host_stop_fn is not None):
                info = {"iteration": st.iter, "mu": mu, "objective": obj_new, "kkt_error": e_0,
                        "theta": theta0}
                if cb.host_fn is not None:
                    cb.host_fn(dict(info, Z=Z_new) if cb.include_primal else info)
                # a host poll halts every active lane, the iterate in flight kept
                if cb.host_stop_fn is not None:
                    with span("host.sync"):
                        poll = bool((active & (st.iter % cb.host_stop_every == 0)).any())
                    if poll and cb.host_stop_fn(dict(info, start_time=t_start)):
                        stopped = torch.ones_like(stopped)
            if cb is not None and cb.stop_fn is not None:
                due = (st.iter % cb.stop_every) == 0
                stopped = stopped | (due & cb.stop_fn(Z_new, st.iter))
            history_Z, hist_n = st.history_Z, st.hist_n
            if hist_k:
                history_Z = _ring_set(st.history_Z, st.iter % hist_k, Z_new)
                hist_n = (st.hist_n + 1).to(i32)
            history_stats = st.history_stats
            if tele_k:
                # the current iterate and the step taken from it (TELEMETRY_COLUMNS)
                row = torch.stack([st.obj, inf_pr, inf_du, mu, e_0, alpha, delta_fin.to(dtype),
                                   theta0], dim=-1)
                history_stats = _ring_set(st.history_stats, st.iter % tele_k, row)
            best_score, best_Z = st.best_score, st.best_Z
            topk_scores, topk_Z = st.topk_scores, st.topk_Z
            if cb is not None and cb.score_fn is not None:
                sc = cb.score_fn(Z_new).to(dtype)
                better = sc > st.best_score
                best_score = torch.where(better, sc, st.best_score)
                best_Z = torch.where(better[:, None], Z_new, st.best_Z)
                if top_k > 1:
                    # replace the worst retained snapshot when beaten
                    worst = st.topk_scores.argmin(-1)
                    beat = sc > st.topk_scores.gather(1, worst[:, None])[:, 0]
                    hit_k = beat[:, None] & (torch.arange(top_k, device=dev) == worst[:, None])
                    topk_scores = torch.where(hit_k, sc[:, None], st.topk_scores)
                    topk_Z = torch.where(hit_k[..., None], Z_new[:, None], st.topk_Z)

            return IPMState(
                Z=Z_new, s=s_new, lam=lam_new, nu=nu_new, zL=zL_new, zU=zU_new, mu=mu,
                theta_max=st.theta_max, theta_min=st.theta_min,
                filter_th=filter_th, filter_ph=filter_ph, filter_n=filter_n,
                c_e=c_e_new, c_i=c_i_new,
                delta_w_last=torch.where(delta_fin > 0, delta_fin, st.delta_w_last),
                stall_count=stall_count, infeasible=infeasible, rest_failed=rest_failed,
                diverged=diverged,
                iter=(st.iter + (~stop_now).to(i32)).to(i32),
                converged=conv_now, acc_count=acc_count, stopped=stopped, err=e_0,
                obj=obj_new,
                best_kkt=best_kkt, best_kkt_ok=best_kkt_ok, best_kkt_Z=best_kkt_Z,
                best_kkt_obj=best_kkt_obj, best_kkt_warm=best_kkt_warm,
                obj_prev=st.obj, osc_count=osc_count, delta_w_boost=delta_w_boost,
                history_Z=history_Z, hist_n=hist_n, history_stats=history_stats,
                best_score=best_score, best_Z=best_Z, topk_scores=topk_scores, topk_Z=topk_Z,
                phi_hist=phi_hist, lbfgs_S=lbfgs_S, lbfgs_Y=lbfgs_Y, lbfgs_n=lbfgs_n,
                # begin the next pair: ∇L at the current iterate under the new
                # multipliers (this iteration's context still holds Z's Jacobians)
                lbfgs_g_prev=(ctx.grad_f + ctx.JeT(lam_new) + ctx.JiT(nu_new)) if lbfgs else None,
                lbfgs_Z_prev=Z if lbfgs else None,
            )

    def cond(st: IPMState) -> torch.Tensor:
        go = (
            (~st.converged) & (~st.infeasible) & (~st.rest_failed) & (~st.diverged)
            & (st.acc_count < options.acceptable_iter) & (st.iter < options.max_iter)
        )
        # without callbacks no lane can be stopped: skip the operation
        return go & (~st.stopped) if cb is not None else go

    t_start = time.monotonic()
    st = state0
    active = cond(st)
    with span("host.sync"):
        more = bool(active.any())
    while more:
        with span("ipm.pass"):
            st = tree_where(active, body(st, active), st)
            active = cond(st)
            with span("host.sync"):
                more = bool(active.any())

    opt_hit = (st.best_kkt <= opt.tol) & st.best_kkt_ok
    acc_hit = st.best_kkt <= opt.acceptable_tol
    status = torch.where(opt_hit, 0, torch.where(acc_hit, 1, torch.where(
        st.infeasible, 4, torch.where(st.rest_failed, 5, torch.where(st.diverged, 6,
            torch.where(st.stopped, 3, 2) if cb is not None else 2))))).to(i32)
    return IPMResult(
        Z=st.best_kkt_Z, state=st, iterations=st.iter, converged=opt_hit | acc_hit,
        status=status, kkt_error=st.best_kkt, objective=st.best_kkt_obj,
        history_Z=st.history_Z, best_Z=st.best_Z, best_score=st.best_score,
        history_stats=st.history_stats, topk_scores=st.topk_scores, topk_Z=st.topk_Z,
    )
