"""Public solve API.

Counterpart of ``directtrajopt_tpu/solvers/solve.py``. Every problem of the
port carries a leading lane axis, so ``solve`` and ``solve_batch`` are the
same batched solve; ``solve_batch_compact`` is the multi-phase
straggler-compacted scheduler of the certified benchmark pipeline.

Not ported yet: ``solve_batch_scheduled``, ``solve_polished`` /
``solve_batch_polished``, callbacks (ROADMAP Queue 1 item 14) and the dense
backend (item 11).
"""

from __future__ import annotations

import warnings
from typing import Any, NamedTuple

import torch

from .. import precision
from ..module import tree_map, tree_take
from ..problem import DirectTrajOptProblem
from .canonical import make_nlp
from .ipm import IPMResult, WarmStart, ipm_solve
from .options import IPMOptions
from .ops_riccati import RiccatiOps, analyze

precision.apply()

__all__ = ["SolveResult", "solve", "solve_batch", "solve_batch_compact", "cast_problem"]


class SolveResult(NamedTuple):
    problem: DirectTrajOptProblem  # with the solution written into the trajectory
    iterations: torch.Tensor
    converged: torch.Tensor
    status: torch.Tensor
    kkt_error: torch.Tensor
    objective: torch.Tensor
    ipm: IPMResult


def _merge_options(options: IPMOptions | None, kwargs: dict) -> IPMOptions:
    options = options or IPMOptions()
    if kwargs:
        unknown = [k for k in kwargs if not hasattr(options, k)]
        if unknown:
            warnings.warn(f"ignoring unknown solver options: {unknown}", stacklevel=3)
            kwargs = {k: v for k, v in kwargs.items() if k not in unknown}
        options = options.replace(**kwargs)
    return options


def _solve_impl(problem: DirectTrajOptProblem, options: IPMOptions, backend: str,
                warm: WarmStart | None) -> SolveResult:
    if backend not in ("auto", "riccati"):
        raise NotImplementedError(f"backend={backend!r}: the dense backend is not ported yet "
                                  "(ROADMAP Queue 1 item 11)")
    nlp = make_nlp(problem)
    if analyze(nlp) is None:
        raise NotImplementedError("problem is not Riccati-eligible and the dense backend is "
                                  "not ported yet (ROADMAP Queue 1 item 11)")
    ops = RiccatiOps(nlp)
    if options.hessian_regularization == "auto":
        # resolved to "inertia", as in the JAX package (see its rationale)
        options = options.replace(hessian_regularization="inertia")
    res = ipm_solve(nlp, problem.trajectory.to_zvec(), options, ops=ops, warm=warm)
    new_prob = problem.replace(trajectory=problem.trajectory.from_zvec(res.Z))
    return SolveResult(
        problem=new_prob, iterations=res.iterations, converged=res.converged,
        status=res.status, kkt_error=res.kkt_error, objective=res.objective, ipm=res,
    )


def solve(problem: DirectTrajOptProblem, options: IPMOptions | None = None, *,
          backend: str = "auto", warm: WarmStart | None = None, **kwargs: Any) -> SolveResult:
    """Solve every lane of ``problem``. Keyword args override option fields.
    ``warm``: a :class:`WarmStart` of per-lane slacks/duals from a previous
    solve (the primal warm start is the trajectory itself)."""
    return _solve_impl(problem, _merge_options(options, kwargs), backend, warm)


solve_batch = solve


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
    iteration counts. Per-lane results do not depend on ``chunk``.
    """
    options = _merge_options(options, kwargs)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
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
            if not bool(todo.any()):
                continue
            if carry_phase:
                wi = tree_take(out.ipm.state.best_kkt_warm, idx)
            elif w_phase is not None:
                wi = tree_take(w_phase, idx)
            else:
                wi = None
            r = _solve_impl(tree_take(cur, idx), opts_p, backend, wi)
            if out is None:
                out = tree_map(lambda x: x.new_zeros((B,) + x.shape[1:]), r)
            out = _scatter(out, r, idx, todo)
            cur = _scatter(cur, r.problem, idx, todo)
            iters = iters.index_copy(0, idx, torch.where(todo, iters[idx] + r.iterations, iters[idx]))
            conv = conv.index_copy(0, idx, conv[idx] | (todo & r.converged))
    return out._replace(problem=cur, iterations=iters, converged=conv)


def cast_problem(problem: DirectTrajOptProblem, dtype: torch.dtype) -> DirectTrajOptProblem:
    """Cast every floating-point tensor of a problem to ``dtype``."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, problem)
