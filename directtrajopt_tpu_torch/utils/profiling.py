"""Profiling hooks.

Counterpart of ``directtrajopt_tpu/utils/profiling.py``:

* :func:`time_structure_build` — host wall time of the structure work a
  solve does before its first iteration (problem lowering, Riccati
  eligibility analysis, operator construction), with the JAX package's
  keys;
* :func:`trace` — a context manager around any solve that records a
  ``torch.profiler`` trace (host operations and, on the card, kernel
  launches and device times) and exports it as a Chrome trace;
* :func:`record` and :func:`span` — the solve path's own spans, kept in
  memory on the wall clock (``time.time_ns``) that ``torch.profiler``
  stamps the card's events with, so that a :class:`Recording` can be laid
  over a device trace. Each layer boundary of a solve opens a span
  (``SPANS``); while nothing records, a span costs one check.

Example::

    from directtrajopt_tpu_torch.utils.profiling import record, trace, time_structure_build

    print(time_structure_build(problem))       # {'make_nlp_s': ..., ...}
    with trace("dtx_trace"):
        solve_batch(batch)
    # then open dtx_trace/trace.json in Perfetto or chrome://tracing

    with record() as rec:
        solve_batch_compact(batch)
    for name, start_ns, end_ns, parent in rec.spans:
        ...
"""

from __future__ import annotations

import contextlib
import os
import time
from time import time_ns

import torch

__all__ = ["trace", "time_structure_build", "record", "span", "Recording", "SPANS"]

# every span the solve path opens, and where
SPANS = {
    "build.library": "ops/_build.library: hash the kernel sources, then load or build",
    "solve.compact": "solve_batch_compact, the whole call (a request's root)",
    "solve.batch": "solve, solve_batch, solve_batch_scheduled, the whole call (a root)",
    "solve.structure": "_solve_impl: lowering, make_nlp and the KKT backend's analysis",
    "ipm.init": "ipm_solve up to its loop: the start point and least-squares duals",
    "ipm.pass": "one lockstep pass of ipm_solve's loop, with the read that ends it",
    "ipm.prepare": "the pass's ops.prepare (derivatives at the iterate) and L-BFGS model",
    "ipm.direction": "optimality errors, barrier update, the KKT step and step bounds",
    "ipm.kkt": "one ctx.kkt_step: factor and solve with the inertia retry",
    "ipm.line_search": "the filter line search: SOC and restoration resolves, trial grid",
    "ipm.update": "the accepted step, filter, certificates and callbacks",
    "host.sync": "a blocking read of the device (the host waits for the queue to drain)",
    "solve.result": "_solve_impl after ipm_solve: write-back and the td error",
}


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


class Recording:
    """The spans of one :func:`record` block, in the order they opened.

    ``spans[i]`` is ``(name, start_ns, end_ns, parent)`` on the clock of
    ``time.time_ns``; ``parent`` is the index of the span open around it,
    or -1. A span with no parent is the root of a request, and its index
    identifies the request for every span under it. ``start_ns`` and
    ``end_ns`` bound the block itself."""

    def __init__(self):
        self.spans: list = []
        self.start_ns = time_ns()
        self.end_ns = -1
        self._open: list = []


class _NoSpan:
    """What :func:`span` returns while nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Span:
    __slots__ = ("_rec", "_name", "_i")

    def __init__(self, rec: Recording, name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        rec = self._rec
        self._i = len(rec.spans)
        rec.spans.append((self._name, time_ns(), -1, rec._open[-1] if rec._open else -1))
        rec._open.append(self._i)
        return self

    def __exit__(self, *exc):
        end = time_ns()
        rec = self._rec
        name, start, _, parent = rec.spans[self._i]
        rec.spans[self._i] = (name, start, end, parent)
        rec._open.pop()
        return False


_NO_SPAN = _NoSpan()
_RECORDING: Recording | None = None


def span(name: str):
    """A context manager that keeps the block as span ``name`` of the open
    :func:`record` block; while nothing records, the shared no-op. A span
    reads no device value, synchronizes nothing and launches nothing."""
    rec = _RECORDING
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name)


@contextlib.contextmanager
def record():
    """Keep every span opened in the block, in memory; yields the
    :class:`Recording`. Recording is process-wide (spans of every thread
    land in it), and ``record`` blocks do not nest."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("spans are already being recorded")
    rec = Recording()
    _RECORDING = rec
    try:
        yield rec
    finally:
        _RECORDING = None
        rec.end_ns = time_ns()
