"""The solve path's own spans (``utils.profiling.record`` / ``span``).

* Off: no span is kept and ``span`` hands out one shared no-op.
* On: per-lane results are bitwise those of the solve without spans; every
  span is one of ``profiling.SPANS``; a lockstep pass is one ``ipm.pass``
  span, ended by one blocking read; children lie inside their parents.
* Clock: a span lies inside the ``torch.profiler`` event around it.

On a bilinear batch at N=9, B=4, solved by ``solve_batch_compact`` in two
phases of two-lane chunks.
"""

import importlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from directtrajopt_tpu_torch import benchmarks as tbench
from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact
from directtrajopt_tpu_torch.utils import profiling
from directtrajopt_tpu_torch.utils.profiling import SPANS, record, span

torch.set_num_threads(1)
solve_mod = importlib.import_module("directtrajopt_tpu_torch.solvers.solve")

KW = dict(tbench.headline_config()["phase1_kw"], phases=((3, None), (24, 1e-2)), chunk=2)


def _passes(r, acceptable_iter):
    """Loop passes of one ``ipm_solve`` from its final state: a lane ran
    ``iter`` passes that stepped, and one more that stopped it where it
    converged or met the acceptable level."""
    st = r.ipm.state
    stopped = st.converged | (st.acc_count >= acceptable_iter)
    return int((st.iter + stopped.to(torch.int32)).max())


@pytest.fixture(scope="module")
def solves():
    """The batch solved without spans and with them (and each solve's loop
    passes, read from its state)."""
    batch = tbench.make_batched_bilinear_problems(4, N=9, taylor_order=6, device="cpu")
    off = solve_batch_compact(batch, **KW)
    passes, impl = [], solve_mod._solve_impl

    def counted(*args):
        r = impl(*args)
        passes.append(_passes(r, KW["acceptable_iter"]))
        return r

    solve_mod._solve_impl = counted
    try:
        with record() as rec:
            on = solve_batch_compact(batch, **KW)
    finally:
        solve_mod._solve_impl = impl
    return off, on, rec, passes


def test_off_records_nothing():
    assert profiling._RECORDING is None
    assert span("ipm.pass") is span("host.sync")
    with span("ipm.pass") as s:
        assert s is span("ipm.kkt")
    with record() as rec:
        pass
    with span("ipm.pass"):
        pass
    assert rec.spans == []
    with record():
        with pytest.raises(RuntimeError):
            with record():
                pass


def test_results_are_bitwise_the_same(solves):
    off, on, _, passes = solves
    assert len(passes) >= 3, "two phases, the first in two chunks"
    for f in ("iterations", "converged"):
        assert torch.equal(getattr(off, f), getattr(on, f))
    assert torch.equal(off.problem.trajectory.to_zvec(), on.problem.trajectory.to_zvec())
    assert torch.equal(off.ipm.Z, on.ipm.Z)


def test_every_span_is_in_the_table(solves):
    rec = solves[2]
    names = {s[0] for s in rec.spans}
    assert names <= set(SPANS)
    assert {"solve.compact", "solve.structure", "ipm.init", "ipm.pass", "ipm.prepare",
            "ipm.direction", "ipm.kkt", "ipm.line_search", "ipm.update", "host.sync",
            "solve.result"} <= names


def test_a_pass_is_a_span_ended_by_one_read(solves):
    _, _, rec, passes = solves
    spans = rec.spans
    kids = {i: [j for j, s in enumerate(spans) if s[3] == i] for i in range(len(spans))}
    pass_ix = [i for i, s in enumerate(spans) if s[0] == "ipm.pass"]
    assert len(pass_ix) == sum(passes)
    for i in pass_ix:
        assert spans[i][3] >= 0 and spans[spans[i][3]][0] == "solve.compact"
        direct = [spans[j][0] for j in kids[i]]
        assert direct.count("host.sync") == 1 and direct[-1] == "host.sync"
        assert direct[:4] == ["ipm.prepare", "ipm.direction", "ipm.line_search", "ipm.update"]
    roots = [s for s in spans if s[3] < 0]
    assert [s[0] for s in roots] == ["solve.compact"]


def test_children_lie_inside_their_parents(solves):
    rec = solves[2]
    spans = rec.spans
    start = np.array([s[1] for s in spans])
    end = np.array([s[2] for s in spans])
    parent = np.array([s[3] for s in spans])
    assert (end >= start).all()
    assert rec.start_ns <= start.min() and end.max() <= rec.end_ns
    has = parent >= 0
    assert (start[has] >= start[parent[has]]).all() and (end[has] <= end[parent[has]]).all()
    dur = end - start
    child = np.bincount(parent[has], weights=dur[has], minlength=len(spans))
    self_ns = dur - child
    assert (self_ns >= 0).all()
    # a parent's duration is its self time and its children's durations
    np.testing.assert_array_equal(self_ns + child, dur)


def test_spans_lie_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record() as rec:
            with record_function("outer"):
                time.sleep(0.001)
                with span("host.sync"):
                    torch.ones(8).sum()
    ev, = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer"]
    (_, s, e, _), = rec.spans
    assert ev.start_ns() - 1_000_000 <= s <= e <= ev.end_ns() + 1_000_000
