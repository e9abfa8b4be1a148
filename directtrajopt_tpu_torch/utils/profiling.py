"""Profiling hooks.

Counterpart of ``directtrajopt_tpu/utils/profiling.py``:

* :func:`time_structure_build` — host wall time of the structure work a
  solve does before its first iteration (problem lowering, Riccati
  eligibility analysis, operator construction), with the JAX package's
  keys;
* :func:`trace` — a context manager around any solve that records a
  ``torch.profiler`` trace (host operations and, on the card, kernel
  launches and device times) and exports it as a Chrome trace.

Example::

    from directtrajopt_tpu_torch.utils.profiling import trace, time_structure_build

    print(time_structure_build(problem))       # {'make_nlp_s': ..., ...}
    with trace("dtx_trace"):
        solve_batch(batch)
    # then open dtx_trace/trace.json in Perfetto or chrome://tracing
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "time_structure_build"]


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace around a block and write it to
    ``logdir/trace.json`` (Chrome trace format). The card's activity is
    recorded where one is present, and the device is synchronized before
    the trace closes, so work launched in the block lands inside it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def time_structure_build(problem, backend: str = "auto") -> dict:
    """Host wall time of the structure work, per stage, as the JAX
    package's ``time_structure_build``: seconds for problem lowering
    (``make_nlp_s``), the Riccati eligibility analysis (``analyze_s``, with
    ``riccati_eligible`` and, where eligible, ``n_promoted_chains`` and
    ``n_border_rows``) and operator construction (``make_ops_s``)."""
    from ..solvers.canonical import make_nlp
    from ..solvers.solve import _make_ops

    out = {}
    t0 = time.perf_counter()
    nlp = make_nlp(problem)
    out["make_nlp_s"] = time.perf_counter() - t0

    if backend in ("auto", "riccati"):
        from ..solvers.ops_riccati import analyze

        t0 = time.perf_counter()
        struct = analyze(nlp)
        out["analyze_s"] = time.perf_counter() - t0
        out["riccati_eligible"] = struct is not None
        if struct is not None:
            out["n_promoted_chains"] = int(struct.promo_jr.shape[1])
            out["n_border_rows"] = int(
                len(struct.bp_steps)
                + len(struct.lin_border_rows)
                + sum(c.constraint_dim(nlp.layout) for c in nlp.eq_cons)
            )

    t0 = time.perf_counter()
    _make_ops(nlp, backend)
    out["make_ops_s"] = time.perf_counter() - t0
    return out
