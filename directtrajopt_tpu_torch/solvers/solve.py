"""Public solve API.

Counterpart of ``directtrajopt_tpu/solvers/solve.py``. Every problem of the
port carries a leading lane axis, so ``solve`` and ``solve_batch`` run the
same batched solve; they differ as in the JAX package: ``solve`` honours a
host-interactive stop (``host_stop_fn``, ``max_wall_time``) and the batch
entry points drop it with a warning. ``solve_batch_scheduled`` is the
host-driven two-phase straggler scheduler, ``solve_batch_compact`` the
multi-phase one of the certified benchmark pipeline, and ``solve_polished``
/ ``solve_batch_polished`` add a float64 polish to a solve in the
problem's dtype.

``backend``: "auto" takes the Riccati backend when the structure analysis
accepts the problem and otherwise the dense one, with a warning; "riccati"
raises on an ineligible problem; "dense" is the dense backend. For "auto"
and "riccati" a spline-order-1 time-dependent integrator whose u is chained
by another explicit integrator is lowered first (``_lower_order1_td``). A
problem with a time-dependent integrator reports the step-doubling error
estimate at its solution (``SolveResult.td_error``), and ``solve`` warns
when it exceeds ``TD_ACCURACY_ATOL``.
"""

from __future__ import annotations

import warnings
from typing import Any, NamedTuple

import torch

from .. import precision
from ..constraints import L1SlackConstraint
from ..integrators.time_dependent import TimeDependentBilinearIntegrator, td_integration_error
from ..module import tree_map, tree_take
from ..problem import DirectTrajOptProblem
from ..utils.profiling import span
from .callbacks import IPMCallbacks
from .canonical import make_nlp
from .ipm import IPMResult, WarmStart, ipm_solve
from .ops_dense import DenseOps
from .options import IPMOptions
from .ops_riccati import RiccatiOps, analyze

precision.apply()

__all__ = ["SolveResult", "solve", "solve_batch", "solve_batch_scheduled", "solve_batch_compact",
           "solve_polished", "solve_batch_polished", "cast_problem", "remove_slack_variables",
           "get_default_options", "set_default_options", "TD_ACCURACY_ATOL"]

# process-global default solver options, used when a solve is called
# without an options object
_DEFAULT_OPTIONS: list = [None]


def get_default_options() -> IPMOptions:
    """Current process-global default solver options."""
    return _DEFAULT_OPTIONS[0] or IPMOptions()


def set_default_options(options: IPMOptions | None) -> None:
    """Set (or with ``None`` reset) the process-global default options."""
    _DEFAULT_OPTIONS[0] = options


class SolveResult(NamedTuple):
    problem: DirectTrajOptProblem  # with the solution written into the trajectory
    iterations: torch.Tensor
    converged: torch.Tensor
    status: torch.Tensor
    kkt_error: torch.Tensor
    objective: torch.Tensor
    ipm: IPMResult
    # the largest step-doubling error estimate of any time-dependent
    # integrator, per lane, re-evaluated at the solution (None without one):
    # n_steps is fixed at set-up (tune_n_steps), so a solve that moved into
    # a stiffer regime shows here
    td_error: torch.Tensor | None = None


def remove_slack_variables(problem: DirectTrajOptProblem) -> DirectTrajOptProblem:
    """Drop the L1 slack components (and their constraints) from a solved
    problem; returns a new problem."""
    slack_names = [c.slack_name for c in problem.constraints if isinstance(c, L1SlackConstraint)]
    if not slack_names:
        return problem
    return problem.replace(
        trajectory=problem.trajectory.remove_components(slack_names),
        constraints=tuple(c for c in problem.constraints if not isinstance(c, L1SlackConstraint)),
    )


def _merge_options(options: IPMOptions | None, kwargs: dict) -> IPMOptions:
    options = options or get_default_options()
    if kwargs:
        unknown = [k for k in kwargs if not hasattr(options, k)]
        if unknown:
            warnings.warn(f"ignoring unknown solver options: {unknown}", stacklevel=3)
            kwargs = {k: v for k, v in kwargs.items() if k not in unknown}
        options = options.replace(**kwargs)
    return options


def _drop_host_stop(options: IPMOptions, callbacks: IPMCallbacks | None, entry: str):
    """The batch entry points run no host-interactive stop: drop
    ``host_stop_fn`` and ``max_wall_time`` with a warning."""
    if (callbacks is not None and callbacks.host_stop_fn is not None) or (
            options.max_wall_time > 0.0):
        warnings.warn(
            f"host-interactive stop (host_stop_fn / max_wall_time) is not supported by "
            f"{entry}; dropping it. Use solve for a host-interactive stop, or "
            f"solve_batch_scheduled for host control between phases.",
            stacklevel=3,
        )
        options = options.replace(max_wall_time=0.0)
        if callbacks is not None:
            callbacks = callbacks.replace(host_stop_fn=None)
    return options, callbacks


def _lower_order1_td(problem: DirectTrajOptProblem) -> DirectTrajOptProblem:
    """Make spline-order-1 time-dependent integrators explicit by
    substituting ``u_{k+1} = F_u(z_k)`` where another explicit integrator
    already determines u's next value from ``z_k`` (a u→du derivative
    chain). Exact: within the chain's feasible set both systems are the
    same, so the lowered problem has the same solutions."""
    integs = list(problem.integrators)
    changed = False
    for i, td in enumerate(integs):
        if (not isinstance(td, TimeDependentBilinearIntegrator) or td.spline_order != 1
                or td.u_next_fn is not None):
            continue
        chain = next((g for g in integs if g is not td and getattr(g, "explicit", False)
                      and getattr(g, "x_name", None) == td.u_name), None)
        if chain is None:
            continue

        def _u_next(layout, zk, _chain=chain):
            # the explicit residual is u_{k+1} − F_u(z_k); at a zero next
            # knot it leaves −F_u(z_k)
            return -_chain.residual(layout, zk, torch.zeros_like(zk))

        integs[i] = td.replace(u_next_fn=_u_next)
        changed = True
    if not changed:
        return problem
    return problem.replace(integrators=tuple(integs))


def _make_ops(nlp, backend: str):
    if backend not in ("auto", "riccati", "dense"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend in ("auto", "riccati"):
        if analyze(nlp) is not None:
            return RiccatiOps(nlp)
        if backend == "riccati":
            raise ValueError("problem is not Riccati-eligible")
        # falling back silently would hide an O((N·d)³)-vs-O(N·d³) cliff
        warnings.warn(
            "problem is not Riccati-eligible (implicit integrator, or a constraint without "
            "knot/global residual structure); using the dense KKT backend — expect "
            "O((N·d)^3) solves", stacklevel=4)
    return DenseOps(nlp)


def _solve_impl(problem: DirectTrajOptProblem, options: IPMOptions, backend: str,
                callbacks: IPMCallbacks | None, warm: WarmStart | None) -> SolveResult:
    options.check_supported(backend)
    with span("solve.structure"):
        lowered = _lower_order1_td(problem) if backend in ("auto", "riccati") else problem
        nlp = make_nlp(lowered)
        ops = _make_ops(nlp, backend)
    if options.hessian_regularization == "auto":
        # resolved to "inertia", as in the JAX package (see its rationale)
        options = options.replace(hessian_regularization="inertia")
    res = ipm_solve(nlp, problem.trajectory.to_zvec(), options, ops=ops, callbacks=callbacks,
                    warm=warm)
    with span("solve.result"):
        # written back into the ORIGINAL problem: the lowering's closure stays out
        new_prob = problem.replace(trajectory=problem.trajectory.from_zvec(res.Z))
        td_err = None
        layout = problem.trajectory.layout
        for integ in problem.integrators:
            if isinstance(integ, TimeDependentBilinearIntegrator):
                zmat = res.Z[:, : layout.N * layout.dim].reshape(-1, layout.N, layout.dim)
                e = td_integration_error(integ, layout, zmat).amax(-1)
                td_err = e if td_err is None else torch.maximum(td_err, e)
    return SolveResult(
        problem=new_prob, iterations=res.iterations, converged=res.converged,
        status=res.status, kkt_error=res.kkt_error, objective=res.objective, ipm=res,
        td_error=td_err,
    )


# the reference's own integrator tests accept atol=1e-3 trajectory agreement;
# tune_n_steps uses the same default bar
TD_ACCURACY_ATOL = 1e-3


def _warn_td_accuracy(res: SolveResult) -> None:
    """Warn when the time-dependent integrator's error estimate at the
    solution exceeds ``TD_ACCURACY_ATOL`` on any lane (one device read)."""
    if res.td_error is None:
        return
    with span("host.sync"):
        e = float(res.td_error.max())
    if e > TD_ACCURACY_ATOL:
        warnings.warn(
            f"time-dependent integrator error estimate at the SOLUTION is {e:.2e} > "
            f"{TD_ACCURACY_ATOL:g}: the solution trajectory left the regime n_steps was tuned "
            f"for — re-tune with tune_n_steps on the solved trajectory and re-solve",
            stacklevel=3)


def solve(problem: DirectTrajOptProblem, options: IPMOptions | None = None, *,
          backend: str = "auto", callbacks: IPMCallbacks | None = None,
          warm: WarmStart | None = None, **kwargs: Any) -> SolveResult:
    """Solve every lane of ``problem``. Keyword args override option fields.
    ``callbacks``: an :class:`IPMCallbacks` bundle (host monitoring, early
    stop, rings, best tracking; a host-interactive stop halts every lane).
    ``warm``: a :class:`WarmStart` of per-lane slacks/duals from a previous
    solve (the primal warm start is the trajectory itself). ``backend``:
    "auto" (Riccati when the problem is an explicit OCP, dense otherwise),
    "riccati" or "dense"."""
    with span("solve.batch"):
        res = _solve_impl(problem, _merge_options(options, kwargs), backend, callbacks, warm)
        _warn_td_accuracy(res)
    return res


def solve_batch(problems: DirectTrajOptProblem, options: IPMOptions | None = None, *,
                backend: str = "auto", callbacks: IPMCallbacks | None = None,
                warm: WarmStart | None = None, **kwargs: Any) -> SolveResult:
    """Solve a batch of problems (all lanes share the static structure and
    may differ in any numeric data). As :func:`solve`, except that a
    host-interactive stop (``host_stop_fn`` / ``max_wall_time``) is dropped
    with a warning, as in the JAX package, whose batch solver cannot run it."""
    options = _merge_options(options, kwargs)
    options, callbacks = _drop_host_stop(options, callbacks, "solve_batch")
    with span("solve.batch"):
        return _solve_impl(problems, options, backend, callbacks, warm)


def solve_batch_scheduled(
    problems: DirectTrajOptProblem,
    options: IPMOptions | None = None,
    *,
    phase1_iter: int = 24,
    phase2_iter: int = 64,
    mu_init_phase2: float | None = 1e-3,
    chunk: int = 128,
    backend: str = "auto",
    **kwargs: Any,
) -> SolveResult:
    """Two-phase straggler-compacted batch solve (the throughput scheduler).

    Phase 1 runs the whole batch up to ``phase1_iter`` iterations. The
    unconverged lanes (the converged mask crosses to the host once) are
    then packed into ``chunk``-lane batches, the last padded with repeats
    of the first straggler, and continue from their phase-1 iterate for up
    to ``phase2_iter`` iterations, primal-only: the barrier restarts at
    ``mu_init_phase2`` (``None`` keeps the option value) and a user ``warm``
    start applies to phase 1 only. Results are scattered back; a phase-2
    lane reports its own phase-1 count plus its phase-2 count.

    ``callbacks`` and ``warm`` pass through ``kwargs`` to both phases (warm:
    phase 1); a host-interactive stop is dropped, as by :func:`solve_batch`.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    callbacks = kwargs.pop("callbacks", None)
    warm = kwargs.pop("warm", None)
    options = _merge_options(options, kwargs)
    options, callbacks = _drop_host_stop(options, callbacks, "solve_batch_scheduled")
    with span("solve.batch"):
        res = _solve_impl(problems, options.replace(max_iter=phase1_iter), backend, callbacks,
                          warm)
        with span("host.sync"):
            bad = torch.nonzero(~res.converged.cpu())[:, 0]
        if len(bad) == 0:
            return res
        opts2 = options.replace(max_iter=phase2_iter)
        if mu_init_phase2 is not None:
            opts2 = opts2.replace(mu_init=mu_init_phase2)
        ch = min(chunk, res.converged.shape[0])
        pad = (-len(bad)) % ch
        idx_all = torch.cat([bad, bad[:1].expand(pad)]).to(res.converged.device)
        out = res
        for c0 in range(0, len(idx_all), ch):
            idx = idx_all[c0:c0 + ch]
            n = min(ch, len(bad) - c0)  # the chunk's lanes before the padding
            r = _solve_impl(tree_take(res.problem, idx), opts2, backend, callbacks, None)
            r = r._replace(iterations=r.iterations + res.iterations[idx])
            out = tree_map(lambda f, p: f.index_copy(0, idx[:n], p[:n]), out, r)
        return out


def _scatter(full, part, idx: torch.Tensor, upd: torch.Tensor):
    """Write ``part``'s lanes into ``full`` at ``idx`` where ``upd`` holds."""

    def scat(f, p):
        m = upd.reshape((-1,) + (1,) * (p.ndim - 1))
        return f.index_copy(0, idx, torch.where(m, p, f.index_select(0, idx)))

    return tree_map(scat, full, part)


def solve_batch_compact(
    problems: DirectTrajOptProblem,
    options: IPMOptions | None = None,
    *,
    phases: tuple = ((14, None), (12, 1e-3), (24, 1e-3), (64, 1e-3)),
    chunk: int = 128,
    backend: str = "auto",
    warm: WarmStart | None = None,
    carry_duals: bool = False,
    **kwargs: Any,
) -> SolveResult:
    """Multi-phase straggler-compacted batch solve.

    Before each phase, lanes are stably sorted by convergence so the
    unconverged ones pack into the leading ``chunk``-lane sub-batches; a
    sub-batch whose lanes are all converged is skipped; each phase
    continues from the previous phase's iterate. ``phases`` is a tuple of
    ``(max_iter, mu_init)`` (``None`` keeps the option value). A user
    ``warm`` start applies to phase 1; with ``carry_duals=True`` later
    phases warm-start every lane from its own best-KKT slacks and duals.
    Each lane reports the phase that last updated it, with combined
    iteration counts. Per-lane results do not depend on ``chunk``. A
    ``max_wall_time`` is dropped with a warning, as by :func:`solve_batch`.
    """
    options = _merge_options(options, kwargs)
    options, _ = _drop_host_stop(options, None, "solve_batch_compact")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    with span("solve.compact"):
        B = problems.B
        dev = problems.trajectory.data[problems.trajectory.names[0]].device
        ch = min(chunk, B)
        pad = (-B) % ch
        n_chunks = (B + pad) // ch
        conv = torch.zeros((B,), dtype=torch.bool, device=dev)
        iters = torch.zeros((B,), dtype=torch.int32, device=dev)
        cur, out = problems, None
        for pi, (p_iter, p_mu) in enumerate(phases):
            opts_p = options.replace(max_iter=int(p_iter))
            if p_mu is not None:
                opts_p = opts_p.replace(mu_init=p_mu)
            carry_phase = carry_duals and pi > 0
            w_phase = warm if pi == 0 else None
            # stable sort: unconverged lanes (0) first, original order kept
            order = torch.argsort(conv.to(torch.int8), stable=True)
            if pad:
                order = torch.cat([order, order[-1:].expand(pad)])
            for idx in order.reshape(n_chunks, ch):
                todo = ~conv[idx]
                with span("host.sync"):
                    skip = not bool(todo.any())
                if skip:
                    continue
                if carry_phase:
                    wi = tree_take(out.ipm.state.best_kkt_warm, idx)
                elif w_phase is not None:
                    wi = tree_take(w_phase, idx)
                else:
                    wi = None
                r = _solve_impl(tree_take(cur, idx), opts_p, backend, None, wi)
                if out is None:
                    out = tree_map(lambda x: x.new_zeros((B,) + x.shape[1:]), r)
                out = _scatter(out, r, idx, todo)
                cur = _scatter(cur, r.problem, idx, todo)
                iters = iters.index_copy(
                    0, idx, torch.where(todo, iters[idx] + r.iterations, iters[idx]))
                conv = conv.index_copy(0, idx, conv[idx] | (todo & r.converged))
        return out._replace(problem=cur, iterations=iters, converged=conv)


def cast_problem(problem: DirectTrajOptProblem, dtype: torch.dtype) -> DirectTrajOptProblem:
    """Cast every floating-point tensor of a problem to ``dtype``."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, problem)


def _polish_options(options: IPMOptions | None, kwargs: dict, polish_tol: float,
                    polish_max_iter: int, polish_mu_init: float) -> IPMOptions:
    """The float64 polish's options: the first phase's, with the polish's
    tolerance, budget and barrier; the warm primal kept (no bound push);
    plain inertia regularization for the in-basin Newton tail."""
    opts = {k: v for k, v in kwargs.items() if k not in ("callbacks", "warm")}
    return _merge_options(options, opts).replace(
        tol=polish_tol, acceptable_tol=polish_tol, max_iter=polish_max_iter,
        mu_init=polish_mu_init, bound_push=1e-9, bound_frac=1e-9,
        hessian_regularization="inertia")


def _to_f64(first: SolveResult):
    """The first phase's solution as a float64 problem, and the slacks and
    duals of its best-KKT iterate (the point the trajectory holds) as the
    polish's warm start."""
    warm = tree_map(lambda x: x.to(torch.float64), first.ipm.state.best_kkt_warm)
    return cast_problem(first.problem, torch.float64), warm


def solve_polished(problem: DirectTrajOptProblem, options: IPMOptions | None = None, *,
                   polish_tol: float = 1e-8, polish_max_iter: int = 450,
                   polish_mu_init: float = 1e-5, backend: str = "auto",
                   callbacks: IPMCallbacks | None = None, **kwargs: Any) -> SolveResult:
    """Mixed-precision solve: a solve in the problem's dtype, then a float64
    polish warm-started from each lane's best-KKT iterate with its slacks
    and duals (restarting the duals would wander off the warm point).

    The card has native float64, so there is no flag to check. The float64
    phase runs the kernels' plain PyTorch versions: the CUDA kernels serve
    float32 only, as the JAX package's Pallas kernels do, whose float64 goes
    to the XLA path."""
    first = solve(problem, options, backend=backend, callbacks=callbacks, **kwargs)
    prob64, warm = _to_f64(first)
    opts64 = _polish_options(options, kwargs, polish_tol, polish_max_iter, polish_mu_init)
    return solve(prob64, opts64, backend=backend, callbacks=callbacks, warm=warm)


def solve_batch_polished(problems: DirectTrajOptProblem, options: IPMOptions | None = None, *,
                         polish_tol: float = 1e-8, polish_max_iter: int = 450,
                         polish_mu_init: float = 1e-5, backend: str = "auto",
                         **kwargs: Any) -> SolveResult:
    """Batched mixed-precision solve (see :func:`solve_polished`): the
    first phase through :func:`solve_batch` on the whole batch, then the
    float64 polish of the same lockstep batch, on the kernels' plain
    versions. ``callbacks`` (through ``kwargs``) reach the first phase
    only, as in the JAX package."""
    first = solve_batch(problems, options, backend=backend, **kwargs)
    prob64, warm = _to_f64(first)
    opts64 = _polish_options(options, kwargs, polish_tol, polish_max_iter, polish_mu_init)
    return solve_batch(prob64, opts64, backend=backend, warm=warm)
