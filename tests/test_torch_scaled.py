"""The scaling family, the Padé default, the "floor" regularization and the
small modules of this slice, held against the JAX package on the same inputs.

* ``make_scaled_problem``: data, residuals and window Jacobians at the guess
  (float64, 1e-12) at state_dim 4, 8 and 16; one small solve (N=11,
  state_dim 8) against the JAX package's float64 solve
  (``tests/golden/torch/scaled.npz``, ``make_scaled.py``): equal
  iterations, Z within 1e-8.
* ``ops.expm.expm_apply`` within 1e-12.
* A default-built bilinear integrator (Padé in both packages): residuals
  within 1e-12.
* ``_stage_project(·, "floor")`` within 1e-12, and a small solve with it
  taking the JAX package's iterations.
* ``utils.testing``: the checks pass on the port's components, and the
  assembled windows equal the JAX package's within 1e-12.
* ``utils.profiling.time_structure_build``: the counts of the JAX package
  on the twin fixtures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import directtrajopt_tpu as dtx
import directtrajopt_tpu_torch as tdx
from directtrajopt_tpu.benchmarks import make_scaled_problem as jax_scaled
from directtrajopt_tpu.integrators.base import stack_jacobians as j_stack_jac
from directtrajopt_tpu.integrators.base import stack_residuals as j_stack_res
from directtrajopt_tpu.ops.expm import expm_apply as j_expm_apply
from directtrajopt_tpu.solvers.ops_riccati import _stage_project as j_stage_project
from directtrajopt_tpu.utils import testing as jtesting
from directtrajopt_tpu.utils.profiling import time_structure_build as j_structure
from directtrajopt_tpu_torch import benchmarks as tb
from directtrajopt_tpu_torch.bridge import from_numpy_problem
from directtrajopt_tpu_torch.integrators.base import stack_jacobians, stack_residuals
from directtrajopt_tpu_torch.ops.expm import expm_apply
from directtrajopt_tpu_torch.solvers.ops_riccati import _stage_project
from directtrajopt_tpu_torch.utils import testing as ttesting
from directtrajopt_tpu_torch.utils.profiling import time_structure_build

from torch_twins import PROBLEMS, G_DRIFT, G_DRIVE, feasible_bilinear_traj, riccati_globals

torch.set_num_threads(1)

# the golden's small solve: the CPU options of bench_sweep.py
SMALL_OPTIONS = dict(tol=1e-8, acceptable_tol=5e-4, acceptable_iter=5,
                     hessian_approximation="gauss_newton", max_iter=378)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("state_dim", [4, 8, 16])
def test_make_scaled_problem_matches_jax(state_dim):
    """The same draws, bounds and pins, and at the guess the same window
    residuals and Jacobians of both integrators (float64, 1e-12)."""
    jp = jax_scaled(N=5, state_dim=state_dim, seed=7)
    tp = tb.make_scaled_problem(5, state_dim, seed=7, device="cpu")
    jt, tt = jp.trajectory, tp.trajectory
    assert tt.names == tuple(jt.names) and tt.timestep == jt.timestep
    for name in jt.names:
        np.testing.assert_array_equal(_np(tt.data[name])[0], np.asarray(jt.data[name]))
    ji, ti = jp.integrators[0], tp.integrators[0]
    assert ti.method == ji.method == "pade"
    np.testing.assert_array_equal(_np(ti.G_drift)[0], np.asarray(ji.G_drift))
    np.testing.assert_array_equal(_np(ti.G_drives)[0], np.asarray(ji.G_drives))
    zj = jt.knot_matrix()
    zt = tt.knot_matrix()
    np.testing.assert_array_equal(_np(zt)[0], np.asarray(zj))
    for jint, tint in zip(jp.integrators, tp.integrators):
        np.testing.assert_allclose(_np(stack_residuals(tint, tt.layout, zt))[0],
                                   np.asarray(j_stack_res(jint, jt.layout, zj)), atol=1e-12,
                                   rtol=0)
        np.testing.assert_allclose(_np(stack_jacobians(tint, tt.layout, zt))[0],
                                   np.asarray(j_stack_jac(jint, jt.layout, zj)), atol=1e-12,
                                   rtol=0)


def test_batched_scaled_lanes_are_the_seeds():
    """Lane i of the batch is ``make_scaled_problem`` at seed 42 + i."""
    bp = tb.make_batched_scaled_problems(3, 4, 5, device="cpu")
    for i in range(3):
        one = tb.make_scaled_problem(4, 5, seed=42 + i, device="cpu")
        assert torch.equal(bp.trajectory.to_zvec()[i], one.trajectory.to_zvec()[0])
        assert torch.equal(bp.integrators[0].G_drives[i], one.integrators[0].G_drives[0])


def test_expm_apply_matches_jax():
    rng = np.random.default_rng(3)
    A = 0.3 * rng.normal(size=(5, 8, 8))
    x = rng.normal(size=(5, 8, 1))
    ref = jax.vmap(j_expm_apply)(jnp.asarray(A), jnp.asarray(x))
    np.testing.assert_allclose(expm_apply(torch.as_tensor(A), torch.as_tensor(x)).numpy(),
                               np.asarray(ref), atol=1e-12, rtol=0)


def test_scaled_small_solve_matches_golden():
    """N=11, state_dim 8 at the golden's options (Gauss-Newton, Padé): the
    JAX package's iterations, Z within 1e-8."""
    gold = np.load(tb.GOLDEN_SCALED)
    res = tdx.solve(tb.make_scaled_problem(11, 8, device="cpu"), **SMALL_OPTIONS)
    assert bool(res.converged[0]) == bool(gold["small_converged"])
    assert int(res.iterations[0]) == int(gold["small_iterations"])
    np.testing.assert_allclose(res.problem.trajectory.to_zvec()[0].numpy(), gold["small_Z"],
                               atol=1e-8, rtol=0)


def test_pade_is_the_default_method():
    """A bilinear integrator built without a method is Padé in both
    packages, with equal residuals (1e-12)."""
    jtraj, _ = feasible_bilinear_traj(N=8)
    ji = dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", None)
    ti = tdx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", batch=1, device="cpu")
    assert ti.method == ji.method == "pade"
    zj = jtraj.knot_matrix()
    lay = tdx.Trajectory.create({k: np.asarray(v)[None] for k, v in jtraj.data.items()},
                                timestep=jtraj.timestep, controls="u", device="cpu").layout
    zt = torch.as_tensor(np.asarray(zj))[None]
    np.testing.assert_allclose(stack_residuals(ti, lay, zt)[0].numpy(),
                               np.asarray(j_stack_res(ji, jtraj.layout, zj)), atol=1e-12, rtol=0)


def test_floor_projection_matches_jax():
    """λ → max(λ, ε) where λ > −ε, unchanged below, per lane."""
    rng = np.random.default_rng(5)
    Q = rng.normal(size=(3, 6, 5, 5))
    Q = Q + np.swapaxes(Q, -1, -2)
    Q[0, 2] = np.diag([1e-9, -1e-9, 2.0, -3.0, 0.0])  # eigenvalues on both sides of ±ε
    ref = jax.vmap(lambda q: j_stage_project(q, "floor"))(jnp.asarray(Q))
    np.testing.assert_allclose(_stage_project(torch.as_tensor(Q), "floor").numpy(),
                               np.asarray(ref), atol=1e-12, rtol=0)


def test_floor_solve_takes_the_jax_iterations():
    """A small exact-Hessian solve with ``hessian_regularization="floor"``
    takes the JAX package's iterations and reaches its Z."""
    jp, fns = riccati_globals()
    kw = dict(hessian_regularization="floor", max_iter=60, tol=1e-7)
    jr = dtx.solve(jp, **kw)
    tr = tdx.solve(from_numpy_problem(jp, "cpu", functions=fns), **kw)
    assert int(tr.iterations[0]) == int(jr.iterations)
    np.testing.assert_allclose(tr.problem.trajectory.to_zvec()[0].numpy(),
                               np.asarray(jr.problem.trajectory.to_zvec()), atol=1e-6, rtol=0)


def test_validators_pass_and_windows_match_jax():
    """``utils.testing`` on the port's integrators (Taylor and Padé bilinear,
    derivative), an objective and a nonlinear constraint; the assembled
    window Jacobian and Hessian equal the JAX package's (1e-12)."""
    jtraj, _ = feasible_bilinear_traj(N=6)
    jprob, fns = PROBLEMS["state_constrained"]()
    tprob = from_numpy_problem(jprob, "cpu", functions=fns)
    ttraj, lay = tprob.trajectory, tprob.trajectory.layout
    N, d, zd = lay.N, lay.dim, lay.z_dim
    for method in ("taylor", "pade"):
        integ = tdx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", batch=1,
                                              device="cpu", method=method)
        ttesting.check_integrator(integ, ttraj)
        jinteg = dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", None,
                                               method=method)
        jz = jprob.trajectory.knot_matrix()
        Jj = jtesting.assemble_window_jacobian(j_stack_jac(jinteg, jprob.trajectory.layout, jz),
                                               N, d, zd)
        Jt = ttesting.assemble_window_jacobian(
            stack_jacobians(integ, lay, ttraj.knot_matrix())[0], N, d, zd)
        np.testing.assert_allclose(Jt, Jj, atol=1e-12, rtol=0)
    from directtrajopt_tpu.integrators.base import stack_hessians as j_stack_hess
    from directtrajopt_tpu_torch.integrators.base import stack_hessians

    mu = np.random.default_rng(1).normal(size=(N - 1, 2))
    Hj = jtesting.assemble_window_hessian(
        j_stack_hess(jinteg, jprob.trajectory.layout, jz, jnp.asarray(mu)), N, d, zd)
    Ht = ttesting.assemble_window_hessian(
        stack_hessians(integ, lay, ttraj.knot_matrix(), torch.as_tensor(mu)[None])[0], N, d, zd)
    np.testing.assert_allclose(Ht, Hj, atol=1e-12, rtol=0)
    deriv = tdx.DerivativeIntegrator.create("u", "du")
    dtraj = tdx.Trajectory.create({k: np.asarray(v)[None] for k, v in jtraj.data.items()}
                                  | {"du": np.zeros((1, 6, 1))}, timestep=jtraj.timestep,
                                  controls="du", device="cpu")
    ttesting.check_integrator(deriv, dtraj)
    ttesting.check_objective(tprob.objective, ttraj)
    con = next(c for c in tprob.constraints if hasattr(c, "evaluate_flat"))
    ttesting.check_constraint(con, ttraj)


@pytest.mark.parametrize("name", sorted(PROBLEMS) + ["riccati_globals"])
def test_time_structure_build_counts_match_jax(name):
    jp, fns = riccati_globals() if name == "riccati_globals" else PROBLEMS[name]()
    got = time_structure_build(from_numpy_problem(jp, "cpu", functions=fns))
    ref = j_structure(jp)
    assert set(got) == set(ref)
    for key in ("riccati_eligible", "n_promoted_chains", "n_border_rows"):
        assert got.get(key) == ref.get(key), key
    assert all(got[k] >= 0 for k in got if k.endswith("_s"))
