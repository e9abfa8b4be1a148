"""The port's scheduled, polished and MPC entry points against the JAX
package's.

* ``solve_batch_scheduled`` on the 5-lane N=14 setup of
  ``tests/test_solve.py::test_solve_batch_scheduled`` (with the Taylor
  integrator), f64: with stragglers (phase 1 capped at 3 iterations, chunk
  2) and without (phase 1 at 200): per-lane iterations equal and Z within
  1e-8 (measured: 3.3e-16 and 1.7e-16).
* ``solve_batch_polished`` on the 3-lane N=11 batch of
  ``tests/test_golden.py::test_batched_polish_converges``, f32 then f64:
  every lane converges in both packages to kkt ≤ 1e-7 (measured: 1.0e-9),
  the result is f64, and the two packages' u, du, ddu agree within 1e-6
  (measured: 7.0e-14). The optimum is u ≡ 0, where every Δt is optimal, so
  Δt and x are not determined (the packages' differ by 2.8e-4).
* ``shift_trajectory`` bitwise equal to the JAX package's, and the 3-step
  MPC loop of ``tests/test_mpc_and_parallel.py::test_mpc_warm_start_loop``
  (Taylor integrator; the JAX side jitted) with equal iterations per step.
* Path 4a's options (``benchmarks.scheduled_config``) on lanes 0-7 of the
  card's batch, f32: every lane converges with kkt ≤ 1e-6 (measured:
  1.8e-7), u, du, ddu within 1e-4 of ``tests/golden/torch/scheduled_n51.npz``
  (measured: 6.3e-6; Δt, which the optimum leaves free, is 1.4e-2 off, as in
  the JAX package's own f32 solve), and the telemetry ring is sound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import directtrajopt_tpu as dtx
import directtrajopt_tpu_torch as tdx
from directtrajopt_tpu import benchmarks as jbench
from directtrajopt_tpu.solvers.solve import cast_problem as j_cast
from directtrajopt_tpu_torch import benchmarks as tbench
from directtrajopt_tpu_torch.bridge import from_numpy_problem
from directtrajopt_tpu_torch.module import tree_take
from torch_twins import bilinear_integrator, feasible_bilinear_traj, rollout

torch.set_num_threads(1)


def _zmax(tr, jr, comps=None):
    """Max |Z_port − Z_jax|, over the named components only if given."""
    Zt = tr.problem.trajectory.to_zvec().double().numpy()
    Zj = np.asarray(jr.problem.trajectory.to_zvec(), dtype=np.float64).reshape(Zt.shape)
    if comps is not None:
        lay = tr.problem.trajectory.layout
        Zt, Zj = (z.reshape(len(z), lay.N, lay.dim) for z in (Zt, Zj))
        Zt, Zj = (np.concatenate([z[..., lay.comp_slice(c)] for c in comps], -1) for z in (Zt, Zj))
    return float(np.abs(Zt - Zj).max())


@pytest.fixture(scope="module")
def five_lanes():
    probs = []
    for seed in range(5):
        tr, integ = feasible_bilinear_traj(N=14, seed=seed, u_scale=0.2 + 0.05 * seed)
        probs.append(dtx.DirectTrajOptProblem.create(
            tr, dtx.QuadraticRegularizer.create("u", tr, 1.0), integ))
    jp = jax.tree.map(lambda *xs: jnp.stack(xs), *probs)
    return jp, from_numpy_problem(jp, "cpu")


@pytest.mark.parametrize("case", ["stragglers", "no_stragglers"])
def test_scheduled_matches_jax(five_lanes, case):
    jp, tp = five_lanes
    kw = (dict(phase1_iter=3, phase2_iter=200, mu_init_phase2=None, chunk=2)
          if case == "stragglers" else dict(phase1_iter=200))
    jr = dtx.solve_batch_scheduled(jp, **kw)
    tr = tdx.solve_batch_scheduled(tp, **kw)
    assert tr.converged.all() and np.asarray(jr.converged).all()
    it = tr.iterations.numpy()
    assert np.array_equal(np.asarray(jr.iterations), it)
    assert (it > 3).all() if case == "stragglers" else (it <= 200).all()
    assert _zmax(tr, jr) < 1e-8


def test_batch_polished_matches_jax():
    jp = j_cast(jbench.make_batched_bilinear_problems(3, N=11, feasible_start=True), jnp.float32)
    tp = from_numpy_problem(jp, "cpu", dtype=torch.float32)
    kw = dict(tol=1e-6, acceptable_tol=1e-6, acceptable_iter=50, max_iter=80, mu_init=3e-2,
              polish_max_iter=150)
    jr = dtx.solve_batch_polished(jp, **kw)
    tr = tdx.solve_batch_polished(tp, **kw)
    assert tr.problem.trajectory.to_zvec().dtype == torch.float64
    assert tr.converged.all() and np.asarray(jr.converged).all()
    assert float(tr.kkt_error.max()) <= 1e-7 and float(np.asarray(jr.kkt_error).max()) <= 1e-7
    # the optimum (u ≡ 0) determines u, du, ddu; any Δt is optimal there
    assert _zmax(tr, jr, ("u", "du", "ddu")) < 1e-6


def _mpc_problem(N=16, seed=0, x0=(1.0, 0.0)):
    """``tests/test_mpc_and_parallel.py::make_prob`` with the Taylor integrator."""
    rng = np.random.default_rng(seed)
    u = 0.3 * np.sin(np.linspace(0, 5, N))[:, None]
    xs = rollout(x0, u, 0.15)
    traj = dtx.Trajectory.create(
        {"x": xs + 0.03 * rng.normal(size=(N, 2)), "u": u}, timestep=0.15, controls="u",
        initial={"x": list(x0)}, final={"x": xs[-1]})
    return dtx.DirectTrajOptProblem.create(
        traj, dtx.QuadraticRegularizer.create("u", traj, 1.0), bilinear_integrator())


def test_shift_trajectory_bitwise():
    jt = _mpc_problem().trajectory
    tt = from_numpy_problem(_mpc_problem(), "cpu").trajectory
    js = dtx.shift_trajectory(jt, shift=2, new_initial={"x": [0.5, 0.5]})
    ts = tdx.shift_trajectory(tt, shift=2, new_initial={"x": [0.5, 0.5]})
    for name in jt.names:
        assert np.array_equal(ts.data[name][0].numpy(), np.asarray(js.data[name]))
    assert np.array_equal(ts.initial["x"][0].numpy(), np.asarray(js.initial["x"]))


def test_mpc_loop_matches_jax():
    jp = _mpc_problem()
    tp = from_numpy_problem(jp, "cpu")
    jr, tr = dtx.solve_jit(jp, max_iter=100), tdx.solve(tp, max_iter=100)
    assert int(tr.iterations[0]) == int(jr.iterations)
    jcur, tcur = jr.problem, tr.problem
    for step in range(3):
        # "measure" the next state by rolling out one step of the JAX plan
        xs = np.asarray(dtx.rollout(jcur.integrators[0], jcur.trajectory))
        measured = xs[1] + 0.001 * np.random.default_rng(step).normal(size=2)
        jcur = dtx.mpc_step(jcur, {"x": measured}, shift=1)
        tcur = tdx.mpc_step(tcur, {"x": measured}, shift=1)
        assert np.array_equal(tcur.trajectory.data["x"][0, 0].numpy(), measured)
        jr, tr = dtx.solve_jit(jcur, max_iter=100), tdx.solve(tcur, max_iter=100)
        assert bool(jr.converged) and tr.converged.all()
        assert int(tr.iterations[0]) == int(jr.iterations) <= 30
        jcur, tcur = jr.problem, tr.problem


def test_path4a_options_match_reference():
    cfg = tbench.scheduled_config()
    full = tbench.make_batched_bilinear_problems(cfg["batch"], N=cfg["N"], feasible_start=True,
                                                 taylor_order=cfg["taylor_order"], device="cpu")
    prob = tdx.cast_problem(tree_take(full, torch.arange(8)), torch.float32)
    res = tdx.solve_batch_scheduled(prob, **cfg["solve_kw"])
    assert res.converged.all() and float(res.kkt_error.max()) <= 1e-6
    err_det, _ = tbench.scheduled_certificate(res)
    assert err_det <= 1e-4
    assert tbench.telemetry_sound(res).all()
