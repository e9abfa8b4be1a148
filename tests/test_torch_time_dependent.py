"""The time-dependent bilinear integrator, the bilinear integrator's Padé
method and callable generators, and the integrators' closed-form window
Hessians in the port, against the JAX package.

Called live in both packages on the same seeded inputs (float64):

* the residuals, 2·dim window Jacobians and window Hessians
  (``stack_residuals`` / ``stack_jacobians`` / ``stack_hessians``, and
  ``evaluate`` / ``integrator_dim``) of the
  bilinear integrator (Taylor and Padé, array and callable generators),
  the derivative integrator and the time-dependent integrator at spline
  orders 0 and 1, to 1e-12, with the read columns equal to the JAX
  package's; and each ``hessian_zk`` closed form against the JAX package's
  (through ``stack_hessians``, which takes it) and against the port's own
  generic AD;
* ``td_integration_error`` and ``tune_n_steps`` on the fixture of
  ``tests/test_time_dependent.py::test_td_error_estimate_and_n_steps_tuning``
  (the same n_steps, the estimate to 1e-12);
* the Riccati eligibility of orders 0 and 1 (``:63``), and of order 1
  after the lowering.

Whole solves, against ``tests/golden/torch/td_lowering_n10.npz`` (made by
``make_td_order1.py``): the order-1 problem with a u→du chain of ``:127``
on the Riccati backend through the lowering and on the dense backend, with
equal iterations and the objective to 1e-10, the returned problem carrying
the original integrators. The port's own behaviour: the accuracy warning
of ``:251`` and the auto backend's dense-fallback warning.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import directtrajopt_tpu as dtx
import directtrajopt_tpu_torch as tdx
from directtrajopt_tpu.integrators import base as jbase
from directtrajopt_tpu.integrators import td_integration_error as j_td_err
from directtrajopt_tpu.integrators import tune_n_steps as j_tune
from directtrajopt_tpu.solvers.canonical import make_nlp as jmake_nlp
from directtrajopt_tpu.solvers.ops_riccati import analyze as janalyze
from directtrajopt_tpu_torch.bridge import from_numpy_problem
from directtrajopt_tpu_torch.integrators import base as tbase
from directtrajopt_tpu_torch.solvers.canonical import make_nlp as tmake_nlp
from directtrajopt_tpu_torch.solvers.ops_riccati import analyze as tanalyze
from directtrajopt_tpu_torch.solvers.solve import TD_ACCURACY_ATOL, _lower_order1_td

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch", "td_lowering_n10.npz")
G_DRIFT = np.array([[0.0, 1.0], [-1.0, 0.0]])
G_DRIVE = np.array([[0.0, 1.0], [1.0, 0.0]])


def _t(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def g_td_jax(u, t):
    return (1.0 + 0.3 * jnp.sin(t)) * jnp.asarray(G_DRIFT) + u[0] * jnp.asarray(G_DRIVE)


def g_td_torch(u, t):
    return (1.0 + 0.3 * torch.sin(t)) * _t(G_DRIFT, u) + u[0] * _t(G_DRIVE, u)


def g_jax(u):
    return jnp.asarray(G_DRIFT) + u[0] * jnp.asarray(G_DRIVE)


def g_torch(u):
    return _t(G_DRIFT, u) + u[0] * _t(G_DRIVE, u)


def td_traj(N=8, seed=0, free_time=True):
    """``tests/test_time_dependent.py::td_traj`` with a du component and
    perturbed Δt (so the Δt columns carry curvature)."""
    rng = np.random.default_rng(seed)
    dts = np.full((N, 1), 0.1) + 0.01 * rng.normal(size=(N, 1))
    data = {"x": rng.normal(size=(N, 2)) * 0.5, "u": rng.normal(size=(N, 1)) * 0.3,
            "du": rng.normal(size=(N, 1)) * 0.1, "t": np.cumsum(dts, axis=0) - dts[0]}
    if free_time:
        data["dt"] = dts
    return dtx.Trajectory.create(data, timestep="dt" if free_time else 0.1, controls="du")


INTEGRATORS = {
    "bilinear_taylor": lambda tr: (dtx.BilinearIntegrator.create(
        (G_DRIFT, [G_DRIVE]), "x", "u", None, method="taylor"), None),
    "bilinear_pade": lambda tr: (dtx.BilinearIntegrator.create(
        (G_DRIFT, [G_DRIVE]), "x", "u", None, method="pade"), None),
    "bilinear_callable_pade": lambda tr: (dtx.BilinearIntegrator.create(g_jax, "x", "u", None),
                                          g_torch),
    "bilinear_callable_taylor": lambda tr: (dtx.BilinearIntegrator.create(
        g_jax, "x", "u", None, method="taylor"), g_torch),
    "derivative": lambda tr: (dtx.DerivativeIntegrator.create("u", "du", tr), None),
    "td_order0": lambda tr: (dtx.TimeDependentBilinearIntegrator.create(
        g_td_jax, "x", "u", "t", tr, spline_order=0, n_steps=4), g_td_torch),
    "td_order1": lambda tr: (dtx.TimeDependentBilinearIntegrator.create(
        g_td_jax, "x", "u", "t", tr, spline_order=1, n_steps=4), g_td_torch),
}


def _pair(name, free_time=True):
    traj = td_traj(free_time=free_time)
    ji, tfn = INTEGRATORS[name](traj)
    prob = dtx.DirectTrajOptProblem.create(traj, dtx.QuadraticRegularizer.create("u", traj, 1.0),
                                           ji)
    tp = from_numpy_problem(prob, "cpu", functions={("integrator", 0): tfn} if tfn else {})
    return traj, ji, tp


# every integrator with a free Δt; a fixed Δt (another branch of the closed
# forms and of the knot's timestep) on one of each kind
WINDOW_CASES = ([(name, True) for name in INTEGRATORS]
                + [(name, False) for name in ("bilinear_taylor", "derivative", "td_order0")])


@pytest.mark.parametrize("name,free_time", WINDOW_CASES,
                         ids=[f"{n}-{'free' if f else 'fixed'}_dt" for n, f in WINDOW_CASES])
def test_window_derivatives_match_jax(name, free_time):
    traj, ji, tp = _pair(name, free_time)
    layout, tl, ti = traj.layout, tp.trajectory.layout, tp.integrators[0]
    zm = np.asarray(traj.knot_matrix())
    mu = np.random.default_rng(7).normal(size=(traj.N - 1, ji.residual_dim(layout)))
    zj, zt = jnp.asarray(zm), torch.as_tensor(zm)[None]
    jfun = jax.jit(lambda z, m: (jbase.stack_residuals(ji, layout, z),
                                 jbase.stack_jacobians(ji, layout, z),
                                 jbase.stack_hessians(ji, layout, z, m)))
    ref = [np.asarray(a) for a in jfun(zj, jnp.asarray(mu))]
    out = [tbase.stack_residuals(ti, tl, zt)[0], tbase.stack_jacobians(ti, tl, zt)[0],
           tbase.stack_hessians(ti, tl, zt, torch.as_tensor(mu)[None])[0]]
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tbase.evaluate(ti, tp.trajectory)[0].numpy(),
                               np.asarray(jbase.evaluate(ji, traj)), rtol=0, atol=1e-12)
    assert tbase.integrator_dim(ti, tl) == jbase.integrator_dim(ji, layout)
    cj, ct = jbase._window_cols(ji, layout), tbase._window_cols(ti, tl)
    assert (cj is None and ct is None) or np.array_equal(cj, ct)
    assert np.abs(ref[2]).max() > 0 or name == "derivative" and not free_time


@pytest.mark.parametrize("name", ["bilinear_taylor", "bilinear_pade", "bilinear_callable_pade",
                                  "derivative"])
def test_hessian_zk_closed_form_equals_generic_ad(name):
    """The closed form, padded to the window, against the port's generic
    window AD (the integrator with its ``hessian_zk`` hidden)."""
    traj, _, tp = _pair(name)
    tl, ti = tp.trajectory.layout, tp.integrators[0]
    zt = torch.as_tensor(np.asarray(traj.knot_matrix()))[None]
    mu = torch.as_tensor(np.random.default_rng(8).normal(size=(1, traj.N - 1, 2 if "bil" in name
                                                                else 1)))

    class Generic:
        def __getattr__(self, a):
            if a == "hessian_zk":
                raise AttributeError(a)
            return getattr(ti, a)

    closed = tbase.stack_hessians(ti, tl, zt, mu)
    generic = tbase.stack_hessians(Generic(), tl, zt, mu)
    np.testing.assert_allclose(closed.numpy(), generic.numpy(), rtol=0, atol=1e-12)


def test_td_error_estimate_and_tuning_match_jax():
    """``tests/test_time_dependent.py:200``'s fixture: a fast carrier that
    n_steps=10 under-integrates."""
    N, nu = 6, 60.0
    rng = np.random.default_rng(3)
    dts = np.full((N, 1), 1.0)
    traj = dtx.Trajectory.create(
        {"x": rng.normal(size=(N, 2)) * 0.5, "u": rng.normal(size=(N, 1)) * 0.5,
         "t": np.cumsum(dts, axis=0) - 1.0, "dt": dts}, timestep="dt", controls="u")
    td = dtx.TimeDependentBilinearIntegrator.create(
        lambda u, t: (jnp.sin(nu * t) + u[0]) * jnp.asarray(G_DRIFT), "x", "u", "t", traj,
        spline_order=0, n_steps=10)
    prob = dtx.DirectTrajOptProblem.create(traj, dtx.QuadraticRegularizer.create("u", traj, 1.0),
                                           td)
    tp = from_numpy_problem(prob, "cpu", functions={
        ("integrator", 0): lambda u, t: (torch.sin(nu * t) + u[0]) * _t(G_DRIFT, u)})
    tt = tp.integrators[0]
    e_j = np.asarray(j_td_err(td, traj.layout, traj.knot_matrix()))
    e_t = tdx.td_integration_error(tt, tp.trajectory.layout, tp.trajectory.knot_matrix())
    np.testing.assert_allclose(e_t[0].numpy(), e_j, rtol=0, atol=1e-12)
    assert e_j.max() > 1e-3  # the default n_steps misses the bar
    (jt, je), (ttn, te) = j_tune(td, traj, atol=1e-3), tdx.tune_n_steps(tt, tp.trajectory,
                                                                      atol=1e-3)
    assert ttn.n_steps == jt.n_steps > 10
    assert abs(te - je) <= 1e-12 and te <= 1e-3


def _lowering_problem():
    """``tests/test_time_dependent.py:127``: order 1 with a u→du chain."""
    N = 10
    rng = np.random.default_rng(3)
    dts = np.full((N, 1), 0.1)
    traj = dtx.Trajectory.create(
        {"x": rng.normal(size=(N, 2)) * 0.5, "u": rng.normal(size=(N, 1)) * 0.3,
         "du": rng.normal(size=(N, 1)) * 0.1, "t": np.cumsum(dts, axis=0) - 0.1, "dt": dts},
        timestep="dt", controls="du", initial={"x": [1.0, 0.0], "t": [0.0]},
        bounds={"dt": (0.05, 0.2)})
    td = dtx.TimeDependentBilinearIntegrator.create(
        lambda u, t: (1.0 + 0.2 * jnp.sin(t)) * jnp.asarray(G_DRIFT) + u[0] * jnp.asarray(
            G_DRIVE), "x", "u", "t", traj, spline_order=1, n_steps=6)
    chain = dtx.DerivativeIntegrator.create("u", "du", traj)
    obj = (dtx.QuadraticRegularizer.create("u", traj, 1.0)
           + dtx.QuadraticRegularizer.create("du", traj, 0.1))
    prob = dtx.DirectTrajOptProblem.create(traj, obj, [td, chain], constraints=[
        dtx.TimeConsistencyConstraint(time_name="t")])
    tp = from_numpy_problem(prob, "cpu", functions={("integrator", 0): lambda u, t: (
        1.0 + 0.2 * torch.sin(t)) * _t(G_DRIFT, u) + u[0] * _t(G_DRIVE, u)})
    return prob, tp


@pytest.mark.parametrize("order", [0, 1])
def test_riccati_eligibility_matches_jax(order):
    """``tests/test_time_dependent.py:63``; order 1 also after the lowering
    (with the chain of ``:127``)."""
    traj = td_traj()
    td = dtx.TimeDependentBilinearIntegrator.create(g_td_jax, "x", "u", "t", traj,
                                                    spline_order=order)
    prob = dtx.DirectTrajOptProblem.create(traj, dtx.QuadraticRegularizer.create("u", traj, 1.0),
                                           td)
    tp = from_numpy_problem(prob, "cpu", functions={("integrator", 0): g_td_torch})
    assert (tanalyze(tmake_nlp(tp)) is None) == (janalyze(jmake_nlp(prob)) is None) == (
        order == 1)
    prob, tp = _lowering_problem()
    assert tanalyze(tmake_nlp(tp)) is None and janalyze(jmake_nlp(prob)) is None
    assert tanalyze(tmake_nlp(_lower_order1_td(tp))) is not None


@pytest.mark.parametrize("backend", ["riccati", "dense"])
def test_order1_lowering_solve_matches_jax(backend):
    """The lowered Riccati solve and the dense solve of ``:127`` against the
    JAX package's: equal iterations, the objective to 1e-10, the solution
    satisfying the original order-1 residuals, the original integrators
    returned."""
    g = np.load(GOLDEN)
    _, tp = _lowering_problem()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = tdx.solve(tp, backend=backend, tol=1e-10, max_iter=200)
    assert bool(res.converged[0])
    assert int(res.iterations[0]) == int(g[f"iterations_{backend}"])
    assert abs(float(res.objective[0]) - float(g[f"objective_{backend}"])) <= 1e-10
    np.testing.assert_allclose(res.problem.trajectory.to_zvec()[0].numpy(),
                               g[f"Z_{backend}"], rtol=0, atol=1e-8)
    assert res.problem.integrators[0].u_next_fn is None
    r = tbase.stack_residuals(res.problem.integrators[0], res.problem.trajectory.layout,
                              res.problem.trajectory.knot_matrix())
    assert float(r.abs().max()) < 1e-8


def test_td_accuracy_warning():
    """``tests/test_time_dependent.py:251``: the step-doubling estimate at
    the solution flags a solve driven into a stiff regime (u pinned at 3),
    and ``solve`` warns; a benign solve does not."""
    N = 6
    dts = np.full((N, 1), 0.5)
    rng = np.random.default_rng(0)
    traj = dtx.Trajectory.create(
        {"x": rng.normal(size=(N, 2)) * 0.5, "u": np.full((N, 1), 0.05),
         "t": np.cumsum(dts, axis=0) - 0.5, "dt": dts}, timestep="dt", controls="u")
    td = dtx.TimeDependentBilinearIntegrator.create(
        lambda u, t: (0.3 + 4.0 * u[0] ** 2) * jnp.sin(8.0 * t) * jnp.asarray(G_DRIFT),
        "x", "u", "t", traj, spline_order=0, n_steps=6)
    fns = {("integrator", 0): lambda u, t: (0.3 + 4.0 * u[0] ** 2) * torch.sin(8.0 * t)
           * _t(G_DRIFT, u)}
    stiff = dtx.DirectTrajOptProblem.create(
        traj, dtx.QuadraticRegularizer.create("u", traj, 1e-3), td,
        constraints=[dtx.EqualityConstraint.create("u", range(N), 3.0)])
    benign = dtx.DirectTrajOptProblem.create(traj, dtx.QuadraticRegularizer.create("u", traj, 1.0),
                                             td)
    e_init = np.asarray(j_td_err(td, traj.layout, traj.knot_matrix())).max()
    assert e_init < 1e-3
    for prob, bad in ((stiff, True), (benign, False)):
        tp = from_numpy_problem(prob, "cpu", functions=fns)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = tdx.solve(tp, max_iter=4)
        flagged = any("integrator error" in str(x.message) for x in w)
        assert res.td_error is not None and flagged == bad
        assert (float(res.td_error.max()) > TD_ACCURACY_ATOL) == bad


def test_auto_backend_falls_back_to_dense_with_warning():
    """Order 1 without a chain is not Riccati-eligible: "auto" warns and
    takes the dense backend (no Riccati kernel is reached), "riccati"
    raises."""
    traj = td_traj()
    td = dtx.TimeDependentBilinearIntegrator.create(g_td_jax, "x", "u", "t", traj,
                                                    spline_order=1, n_steps=4)
    prob = dtx.DirectTrajOptProblem.create(traj, dtx.QuadraticRegularizer.create("u", traj, 1.0),
                                           td)
    tp = from_numpy_problem(prob, "cpu", functions={("integrator", 0): g_td_torch})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = tdx.solve(tp, max_iter=2)
    assert any("not Riccati-eligible" in str(x.message) for x in w)
    assert res.iterations.shape == (1,) and res.td_error.shape == (1,)
    with pytest.raises(ValueError, match="Riccati-eligible"):
        tdx.solve(tp, backend="riccati", max_iter=2)
