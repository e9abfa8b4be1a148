"""The port's solver callbacks against the JAX package's.

* Telemetry: the ``bilinear_n10`` goldens' problems (seeds 0-2, f64) as one
  batch in each package with ``telemetry(64)``: per-lane iteration counts
  equal and every row of the (lanes, 64, 8) ring within rtol 1e-8 / atol
  1e-12 (measured: the worst |Δ| is 2.0e-4 of that bound; 7.5e-12 relative
  on inf_du, 1.3e-8 relative on a θ of 5e-7). The first check of the
  port's IPM iteration by iteration.
* ``stop_iteration(3)`` with a 4-iterate history ring: status 3, equal
  iterations, Z and the ring within 1e-10 (measured: 3.3e-14 and 3.6e-14).
* ``fidelity_stop`` merged with ``best_fidelity_tracker(top_k=3)``: the same
  stop iteration (3), ``best_score`` and ``best_Z`` within 1e-10, and the
  same set of top-3 scores within 1e-10 (measured: 3.3e-16 each).
* The port alone: ``host_fn`` once per lockstep iteration with (B,)
  tensors and ``print_level=5`` one line per iteration; ``host_stop_fn``
  and ``max_wall_time`` on ``solve`` halt with status 3; the batch entry
  points drop them with the JAX package's warning (which ``solve_batch`` in
  the JAX package gives and its ``solve_batch_compact`` /
  ``solve_batch_scheduled`` do not); two solves that share one
  ``wall_clock_stop`` keep their own clocks; default options round trip.
"""

import itertools
import os
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import directtrajopt_tpu as dtx
import directtrajopt_tpu_torch as tdx
from directtrajopt_tpu import benchmarks as jbench
from directtrajopt_tpu_torch.bridge import from_numpy_problem
from directtrajopt_tpu_torch.solvers.callbacks import _wall_stop_cached, wall_clock_stop
from torch_twins import bilinear_integrator, rollout

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TELE_RTOL, TELE_ATOL = 1e-8, 1e-12


def _golden_batch():
    """The problems of ``bilinear_n10_seed{0,1,2}.npz``, stacked (JAX)."""
    probs = []
    for seed in range(3):
        meta = np.load(os.path.join(GOLDEN, f"bilinear_n10_seed{seed}.npz"))
        p = jbench.make_bilinear_problem(N=int(meta["N"]), seed=seed,
                                         free_time=bool(meta["free_time"]))
        assert np.allclose(np.asarray(p.trajectory.to_zvec()), meta["Z0"], atol=1e-12)
        probs.append(p)
    return jax.tree.map(lambda *xs: jnp.stack(xs), *probs)


@pytest.fixture(scope="module")
def golden_batch():
    jp = _golden_batch()
    return jp, from_numpy_problem(jp, "cpu")


@pytest.fixture(scope="module")
def telemetry_runs(golden_batch):
    jp, tp = golden_batch
    kw = dict(tol=1e-9, max_iter=300)
    return (dtx.solve_batch(jp, callbacks=dtx.telemetry(64), **kw),
            tdx.solve_batch(tp, callbacks=tdx.telemetry(64), **kw))


def test_telemetry_matches_jax_every_iteration(telemetry_runs):
    jr, tr = telemetry_runs
    it = tr.iterations.numpy()
    assert np.array_equal(np.asarray(jr.iterations), it)
    assert tr.converged.all() and it.max() < 64  # the ring holds every iteration
    hj = np.asarray(jr.ipm.history_stats)
    ht = tr.ipm.history_stats.numpy()
    assert ht.shape == hj.shape == (3, 64, len(tdx.TELEMETRY_COLUMNS))
    np.testing.assert_allclose(ht, hj, rtol=TELE_RTOL, atol=TELE_ATOL)
    # rows 0..iterations describe the iterates (the final one with α = 0); the rest are 0
    for lane, n in enumerate(it):
        assert np.isfinite(ht[lane, : n + 1]).all() and not ht[lane, n + 1 :].any()
        assert ht[lane, n, tdx.TELEMETRY_COLUMNS.index("alpha")] == 0.0


def test_stop_iteration_and_history_ring(golden_batch):
    jp, tp = golden_batch
    kw = dict(max_iter=100, tol=1e-14, acceptable_tol=1e-14)
    jcb = dtx.stop_iteration(3).merged_with(dtx.IPMCallbacks(history_size=4))
    tcb = tdx.stop_iteration(3).merged_with(tdx.IPMCallbacks(history_size=4))
    jr = dtx.solve_batch(jp, callbacks=jcb, **kw)
    tr = tdx.solve_batch(tp, callbacks=tcb, **kw)
    assert (tr.status == 3).all() and np.array_equal(np.asarray(jr.status), tr.status.numpy())
    assert np.array_equal(np.asarray(jr.iterations), tr.iterations.numpy())
    np.testing.assert_allclose(tr.problem.trajectory.to_zvec().numpy(),
                               np.asarray(jr.problem.trajectory.to_zvec()), rtol=0, atol=1e-10)
    assert np.array_equal(np.asarray(jr.ipm.state.hist_n), tr.ipm.state.hist_n.numpy())
    assert tr.ipm.history_Z.shape == (3, 4, tp.trajectory.layout.z_dim)
    np.testing.assert_allclose(tr.ipm.history_Z.numpy(), np.asarray(jr.ipm.history_Z),
                               rtol=0, atol=1e-10)


def _fidelity_problem(N=20, seed=0):
    """``tests/test_callbacks.py::make_prob`` with the Taylor integrator."""
    rng = np.random.default_rng(seed)
    u = 0.3 * np.sin(np.linspace(0, 6, N))[:, None]
    xs = rollout([1.0, 0.0], u, 0.15)
    traj = dtx.Trajectory.create(
        {"x": xs + 0.05 * rng.normal(size=(N, 2)), "u": u}, timestep=0.15, controls="u",
        initial={"x": [1.0, 0.0]}, final={"x": xs[-1]}, goal={"x": xs[-1]})
    prob = dtx.DirectTrajOptProblem.create(
        traj, dtx.QuadraticRegularizer.create("u", traj, 1.0), bilinear_integrator())
    return prob, xs[-1]


def test_fidelity_stop_and_top_k_tracker_match_jax():
    jp, goal = _fidelity_problem()
    tp = from_numpy_problem(jp, "cpu")
    kw = dict(max_iter=100, tol=1e-30, acceptable_tol=1e-30)
    ji, ti = jp.integrators[0], tp.integrators[0]
    # 1 − 1e-10: fidelity is 1 − 3.2e-9 after iteration 1 and 1 − 1.2e-12
    # after iteration 2, so the stop comes at the third pass with three snapshots
    fid = 1.0 - 1e-10
    jcb = dtx.fidelity_stop(ji, jp.trajectory, goal, fid_threshold=fid).merged_with(
        dtx.best_fidelity_tracker(ji, jp.trajectory, goal, top_k=3))
    tcb = tdx.fidelity_stop(ti, tp.trajectory, goal, fid_threshold=fid).merged_with(
        tdx.best_fidelity_tracker(ti, tp.trajectory, goal, top_k=3))
    jr = dtx.solve_jit(jp, callbacks=jcb, **kw)
    tr = tdx.solve(tp, callbacks=tcb, **kw)
    assert int(tr.status[0]) == int(jr.status) == 3
    assert int(tr.iterations[0]) == int(jr.iterations) == 3
    assert float(tr.ipm.best_score[0]) >= fid
    assert torch.isfinite(tr.ipm.topk_scores).all()
    np.testing.assert_allclose(float(tr.ipm.best_score[0]), float(jr.ipm.best_score),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(tr.ipm.best_Z[0].numpy(), np.asarray(jr.ipm.best_Z),
                               rtol=0, atol=1e-10)
    assert tr.ipm.topk_scores.shape == (1, 3)
    assert tr.ipm.topk_Z.shape == (1, 3, jp.trajectory.layout.z_dim)
    np.testing.assert_allclose(np.sort(tr.ipm.topk_scores[0].numpy()),
                               np.sort(np.asarray(jr.ipm.topk_scores)), rtol=0, atol=1e-10)
    # the single best is one of the retained snapshots
    k = int(tr.ipm.topk_scores[0].argmax())
    assert torch.equal(tr.ipm.topk_Z[0, k], tr.ipm.best_Z[0])


def _port_batch(B=3, N=11):
    return tdx.make_batched_bilinear_problems(B, N=N, feasible_start=True, taylor_order=6,
                                              device="cpu")


def test_host_fn_and_print_level(capsys):
    prob = _port_batch()
    calls = []

    def monitor(info):
        calls.append({k: v.clone() for k, v in info.items()})

    cb = tdx.IPMCallbacks(host_fn=monitor, include_primal=True)
    res = tdx.solve(prob, callbacks=cb, max_iter=60, print_level=5)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("it=")]
    assert res.converged.all()
    # one call and one line per lockstep iteration: the slowest lane's
    # iterations, and the pass that found it converged
    n_passes = int(res.iterations.max()) + 1
    assert len(calls) == len(lines) == n_passes
    for i, info in enumerate(calls):
        assert set(info) == {"iteration", "mu", "objective", "kkt_error", "theta", "Z"}
        assert all(v.shape == (3,) for k, v in info.items() if k != "Z")
        assert info["Z"].shape == (3, prob.trajectory.layout.z_dim)
        assert int(info["iteration"].max()) == i
    fields = [f.split("=")[0] for f in lines[0].split(" ") if "=" in f]
    assert fields == ["it", "mu", "obj", "th", "e0", "emu", "a", "amax", "soc", "dw", "ok"]


def test_host_stop_and_wall_time_halt_solve():
    prob = _port_batch()
    polls = []

    def host_stop(info):
        polls.append(int(info["iteration"].min()))
        assert info["start_time"] <= time.monotonic()
        return len(polls) >= 2  # stop at the second poll

    kw = dict(max_iter=400, tol=0.0, acceptable_tol=0.0)
    res = tdx.solve(prob, callbacks=tdx.IPMCallbacks(host_stop_fn=host_stop, host_stop_every=3),
                    **kw)
    assert polls == [0, 3]
    assert (res.status == 3).all() and (res.iterations == 4).all()
    start = tdx.solve(prob, max_iter=1)
    assert torch.isfinite(res.problem.trajectory.to_zvec()).all()
    assert (res.kkt_error < start.kkt_error).all()  # the progress is kept
    # the max_wall_time option: a generous budget leaves the solve alone,
    # a tiny one stops it
    ok = tdx.solve(prob, max_iter=60, max_wall_time=300.0)
    ref = tdx.solve(prob, max_iter=60)
    assert torch.equal(ok.iterations, ref.iterations) and ok.converged.all()
    short = tdx.solve(prob, max_wall_time=0.05, **dict(kw, max_iter=200))
    assert (short.status == 3).all() and int(short.iterations.max()) < 200


@pytest.mark.parametrize("entry", ["solve_batch", "solve_batch_compact", "solve_batch_scheduled"])
def test_batch_entry_points_drop_host_stop(entry):
    prob = _port_batch()

    def host_stop(info):
        raise AssertionError("must never run inside a batch entry point")

    cb = tdx.IPMCallbacks(host_stop_fn=host_stop, host_stop_every=1)
    kw = {"callbacks": cb} if entry != "solve_batch_compact" else {}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = getattr(tdx, entry)(prob, max_wall_time=1e-9, **kw)
    assert any("host-interactive stop" in str(x.message) for x in w)
    assert res.converged.all()


def test_shared_wall_clock_stop_keeps_each_solves_clock(monkeypatch):
    # the cached instance of the max_wall_time option holds no clock of its own
    assert _wall_stop_cached(1.0) is _wall_stop_cached(1.0)
    stop = wall_clock_stop(1.0, every=1).host_stop_fn
    now = time.monotonic()
    old = {"iteration": torch.tensor([5]), "start_time": now - 10.0}
    new = {"iteration": torch.tensor([0]), "start_time": now}
    # a second solve starting (iteration 0) does not re-anchor the first
    assert stop(old) and not stop(new) and stop(old)
    # two solves sharing one callback object each run their own budget: on a
    # clock that advances 0.1 s a reading, a budget of 0.35 s stops each
    # solve at the same iteration (an anchor kept from the first solve would
    # stop the second at its first poll)
    clock = itertools.count()
    monkeypatch.setattr(time, "monotonic", lambda: 0.1 * next(clock))
    cb = wall_clock_stop(0.35, every=1)
    prob = _port_batch(B=1)
    kw = dict(max_iter=300, tol=0.0, acceptable_tol=0.0, callbacks=cb)
    r1, r2 = tdx.solve(prob, **kw), tdx.solve(prob, **kw)
    assert int(r1.status[0]) == int(r2.status[0]) == 3
    assert int(r1.iterations[0]) == int(r2.iterations[0]) == 4


def test_default_options_round_trip():
    assert tdx.get_default_options() == tdx.IPMOptions()
    opts = tdx.IPMOptions(max_iter=3, tol=1e-14, acceptable_tol=1e-14)
    try:
        tdx.set_default_options(opts)
        assert tdx.get_default_options() is opts
        res = tdx.solve(_port_batch(B=1))
        assert int(res.iterations[0]) == 3 and int(res.status[0]) == 2
    finally:
        tdx.set_default_options(None)
    assert tdx.get_default_options() == tdx.IPMOptions()
