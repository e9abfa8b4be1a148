"""End-to-end solves of the constrained problems in the port.

* Against JAX (f64): a 3-lane batch of the state-constrained family at N=11
  and the L1-slack problem, carried across by ``bridge``. Per-lane
  iteration counts and converged flags must be equal and Z agree to 1e-7
  (the end-to-end bound of ``tests/test_torch_pipeline.py``).
* Every constrained problem of ``tests/test_solve.py`` (92-241) and
  ``tests/test_promotion.py`` through ``solve`` / ``solve_batch`` /
  ``solve_batch_compact``: converged, its semantic property at the solution,
  and the iteration count of the JAX package's solve of the same problem
  (``directtrajopt_tpu.solve``, f64, tol 1e-7; recorded in ``JAX_ITERS``
  because a cold JAX solve costs several seconds of compile per problem).
  Each of these problems is also held live against the JAX package, one
  KKT step at a time, in ``tests/test_torch_constraints.py``.
* The golden optima (no JAX solve): the ``bilinear_goal_n10`` goldens at
  f64 to RMS(u), RMS(x) < 1e-4, and the state-constrained family at f32 on
  the card's configuration against ``tests/golden/torch/state_constrained_n51.npz``.
* The state-constrained family at a tight cap (1.2), where the JAX package
  converges in f64 but not in f32 with compensated residuals: the port's
  per-lane outcome at f32 against the JAX package's (16 lanes), and lane 0
  in f64 against the JAX package's solve.
"""

import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import directtrajopt_tpu as dtx
import directtrajopt_tpu_torch as tdx
from directtrajopt_tpu.solvers.solve import solve_batch_compact as j_compact
from directtrajopt_tpu_torch import benchmarks as tbench
from directtrajopt_tpu_torch.bridge import from_numpy_problem, from_numpy_warm
from directtrajopt_tpu_torch.solvers.solve import cast_problem
from torch_twins import PROBLEMS, l1_slack, state_constrained

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# iterations of the JAX package's solve (f64, tol 1e-7, max_iter 300) of each problem
JAX_ITERS = {
    "time_consistency": 14, "timesteps_all_equal_promotion": 7, "pinned_final_t": 72,
    "minimum_time": 32, "duration": 28, "duration_range": 20, "timesteps_all_equal": 6,
    "symmetry": 4, "l1_slack": 15, "state_constrained": 7, "nonlinear_mixed": 9,
}


@pytest.fixture(scope="module")
def e2e():
    """The two problems solved by both packages (f64, tol 1e-7)."""
    out = {}
    for name, (jp, fns) in (("state_constrained_batch", state_constrained(3, 11)),
                            ("l1_slack", l1_slack())):
        jr = dtx.solve_batch(jp, max_iter=300, tol=1e-7) if name.endswith("batch") else \
            dtx.solve(jp, max_iter=300, tol=1e-7)
        tr = tdx.solve(from_numpy_problem(jp, "cpu", functions=fns), max_iter=300, tol=1e-7)
        out[name] = (jr, tr)
    return out


@pytest.mark.parametrize("name", ["state_constrained_batch", "l1_slack"])
def test_solve_matches_jax(e2e, name):
    jr, tr = e2e[name]
    assert np.array_equal(np.atleast_1d(np.asarray(jr.iterations)), tr.iterations.numpy())
    assert np.array_equal(np.atleast_1d(np.asarray(jr.converged)), tr.converged.numpy())
    assert tr.converged.all()
    Zj = np.asarray(jax.device_get(jr.problem.trajectory.to_zvec())).reshape(tr.iterations.shape[0], -1)
    assert np.max(np.abs(Zj - tr.problem.trajectory.to_zvec().numpy())) < 1e-7


def test_warm_start_carries_slacks_and_duals(e2e):
    """The JAX solution's slacks and duals, carried across, restart the port
    at the optimum: it converges at once."""
    jr, tr = e2e["l1_slack"]
    warm = from_numpy_warm(jr.ipm.state.best_kkt_warm, "cpu")
    assert warm.s.shape == warm.nu.shape == (1, 32)  # |du| ≤ s: two rows per knot
    res = tdx.solve(tr.problem, warm=warm, max_iter=50, tol=1e-7, mu_init=1e-9)
    assert res.converged.all() and int(res.iterations[0]) <= 2


def _semantics(name, prob, tr):
    """The property each problem's JAX test asserts at the solution."""
    traj = tr.problem.trajectory
    x = traj.data["x"][0].numpy()
    if name in ("time_consistency", "pinned_final_t"):
        t, dt = traj.data["t"][0, :, 0].numpy(), traj.data["dt"][0, :, 0].numpy()
        assert np.max(np.abs(t[1:] - t[:-1] - dt[:-1])) < 1e-7
    elif name in ("timesteps_all_equal", "timesteps_all_equal_promotion"):
        dts = traj.data["dt"][0, :, 0].numpy()
        assert np.max(np.abs(dts - dts[-1])) < 1e-6
    elif name == "minimum_time":
        dts = traj.data["dt"][0, :, 0].numpy()
        assert np.all(dts >= 0.03 - 1e-6) and np.all(dts <= 0.3 + 1e-6)
        assert float(traj.get_duration()[0]) < 0.15 * 15
    elif name == "duration":
        assert abs(float(traj.get_duration()[0]) - 0.15 * 15) < 1e-6
    elif name == "duration_range":
        assert abs(float(traj.get_duration()[0]) - (0.15 * 15 - 0.2)) < 1e-6  # lb active
    elif name == "symmetry":
        v = traj.data["v"][0, :, 0].numpy()
        assert np.max(np.abs(v - v[::-1])) < 1e-7
    elif name == "l1_slack":
        du, s = traj.data["du"][0, :, 0].numpy(), traj.data["s"][0, :, 0].numpy()
        assert np.all(np.abs(du) <= s + 1e-6) and np.sum(np.abs(du) < 1e-5) > 8
    elif name == "state_constrained":
        cap = float(np.max(np.sum(prob.trajectory.data["x"][0].numpy() ** 2, axis=1))) + 0.2
        assert np.all(np.sum(x**2, axis=1) <= cap + 1e-6)
    elif name == "nonlinear_mixed":
        assert abs(np.sum(x[6] ** 2) - 1.0) < 1e-7


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_constrained_problems_solve(name):
    jp, fns = PROBLEMS[name]()
    prob = from_numpy_problem(jp, "cpu", functions=fns)
    kw = dict(max_iter=300, tol=1e-7)
    if name == "symmetry":
        # through the compact scheduler: one phase and one chunk is a plain solve
        tr = tdx.solve_batch_compact(prob, phases=((300, None),), chunk=1, tol=1e-7)
    else:
        tr = (tdx.solve_batch if name.startswith("time") else tdx.solve)(prob, **kw)
    assert tr.converged.all(), (tr.status, tr.kkt_error)
    assert int(tr.iterations[0]) == JAX_ITERS[name]
    _semantics(name, prob, tr)


@pytest.mark.parametrize("seed", range(5))
def test_goal_goldens(seed):
    """The terminal-objective goldens (scipy trust-constr optima) from their
    stored start, at f64, as ``tests/test_golden.py`` holds the JAX package."""
    data = np.load(os.path.join(GOLDEN, f"bilinear_goal_n10_seed{seed}.npz"))
    prob = tbench.make_bilinear_problem(N=int(data["N"]), seed=seed, free_time=False,
                                        goal_objective=float(data["goal_objective"]),
                                        device="cpu")
    np.testing.assert_allclose(prob.trajectory.to_zvec()[0].numpy(), data["Z0"], atol=1e-12)
    res = tdx.solve(prob, tol=1e-9, max_iter=300)
    assert res.converged.all()
    layout = prob.trajectory.layout
    N, d = layout.N, layout.dim
    Z = res.problem.trajectory.to_zvec()[0].numpy().reshape(N, d)
    Zg = np.asarray(data["Z_star"]).reshape(N, d)
    for comp in ("u", "x"):
        sl = layout.comp_slice(comp)
        assert np.sqrt(np.mean((Z[:, sl] - Zg[:, sl]) ** 2)) < 1e-4, comp


def test_state_constrained_builder_matches_twin_and_golden():
    """The card's builder poses the JAX twin's problems (lane ℓ from seed ℓ),
    and its lane 0 is the golden's problem."""
    jp, _ = state_constrained(2, 51)
    tp = tbench.make_batched_state_constrained_problems(2, N=51, device="cpu")
    np.testing.assert_allclose(tp.trajectory.to_zvec().numpy(),
                               np.asarray(jp.trajectory.to_zvec()), rtol=0, atol=1e-12)
    g = np.load(tbench.GOLDEN_STATE_CONSTRAINED)
    np.testing.assert_allclose(tp.trajectory.to_zvec()[0].numpy(), g["Z0"], rtol=0, atol=1e-12)
    assert int(g["N"]) == 51 and int(g["status"]) == 0
    assert "make_state_constrained.py" in str(g["command"])


def test_state_constrained_f32_certificate():
    """The card's path 2 at 4 lanes on the CPU: float32, exact Hessian,
    compensated residuals, tol 1e-6; every lane converges within kkt 1e-6,
    |u − u*| ≤ 1e-4 of the float64 golden, and ‖x_k‖² ≤ cap."""
    cfg = tbench.state_constrained_config()
    prob = cast_problem(tbench.make_batched_state_constrained_problems(4, N=cfg["N"],
                                                                       device="cpu"), torch.float32)
    res = tdx.solve_batch_compact(prob, **dict(cfg["solve_kw"], chunk=4))
    assert res.converged.all() and float(res.kkt_error.max()) <= 1e-6
    err, viol = tbench.state_constrained_certificate(res)
    assert err.max() <= 1e-4 and viol.max() <= 1e-6, (err, viol)


def test_tight_cap_f32_outcome_matches_jax():
    """Path 2's family with cap = 1.2, 16 lanes, the card's options in f32:
    the JAX package certifies no lane (its f64 solve converges), and neither
    does the port: the per-lane converged flags are equal. The port matches
    the reference's failure, it does not repair it.

    The f32 runs split from the first step (this family's first KKT systems
    are so ill-conditioned that f32 and f64 steps differ by O(1)), so the
    lane-by-lane statuses and iteration counts differ. What a faulty port
    would not reproduce is held instead: every lane's KKT error at the start
    equals JAX's to f32 rounding, the port's first f32 iterate is as close to
    the f64 iterate as JAX's own f32 iterate is (within 3x, plus 1e-3), and
    every lane of both packages stops on the iteration limit or a failed
    restoration (status 2 or 5), with a finite Z."""
    B, cap = 16, 1.2
    cfg = tbench.state_constrained_config()
    kw = dict(cfg["solve_kw"], chunk=B)
    jp, _ = state_constrained(B, 51, cap=cap)
    tp = tbench.make_batched_state_constrained_problems(B, N=51, device="cpu", cap=cap)
    np.testing.assert_allclose(tp.trajectory.to_zvec().numpy(),
                               np.asarray(jp.trajectory.to_zvec()), rtol=0, atol=1e-12)
    jp32, tp32 = dtx.cast_problem(jp, jnp.float32), cast_problem(tp, torch.float32)
    jr = j_compact(jp32, **kw)
    tr = tdx.solve_batch_compact(tp32, **kw)
    assert np.array_equal(np.asarray(jr.converged), tr.converged.numpy())
    assert not tr.converged.any()
    assert set(np.asarray(jr.status).tolist()) <= {2, 5}
    assert set(tr.status.tolist()) <= {2, 5}
    assert torch.isfinite(tr.problem.trajectory.to_zvec()).all()

    one = dict(kw, phases=((1, None),))
    j1 = j_compact(jp32, **one).ipm.state
    t1 = tdx.solve_batch_compact(tp32, **one).ipm.state
    ref = np.asarray(j_compact(jp, **one).ipm.state.Z)
    np.testing.assert_allclose(t1.err.numpy(), np.asarray(j1.err), rtol=1e-5, atol=0)
    e_jax = np.abs(np.asarray(j1.Z, np.float64) - ref).max(1)
    e_port = np.abs(t1.Z.double().numpy() - ref).max(1)
    assert np.all(e_port <= 3.0 * e_jax + 1e-3), (e_port, e_jax)


def test_tight_cap_f64_matches_jax():
    """Lane 0 of the cap-1.2 family in f64 (tol 1e-6), where the JAX package
    converges: the port takes the same iterations to the same Z (1e-8)."""
    jp, _ = state_constrained(1, 51, cap=1.2)
    kw = dict(tol=1e-6, max_iter=100)
    jr = dtx.solve(jp, **kw)  # one lane: an unbatched problem
    tr = tdx.solve(tbench.make_batched_state_constrained_problems(1, N=51, device="cpu",
                                                                  cap=1.2), **kw)
    assert bool(jr.converged) and tr.converged.all()
    assert int(jr.iterations) == int(tr.iterations[0])
    Zj = np.asarray(jr.problem.trajectory.to_zvec())
    assert np.max(np.abs(Zj - tr.problem.trajectory.to_zvec().numpy())) < 1e-8
