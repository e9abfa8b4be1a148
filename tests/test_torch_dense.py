"""The dense KKT backend in the port, against the JAX package.

Called live in both packages on the same seeded inputs (float64):

* ``COORows.dense`` and the dense assembly — ``jac_eq``, ``jac_in`` and
  ``hess_lagrangian`` (exact and Gauss-Newton) — on constrained and global
  fixtures of ``tests/torch_twins.py``, to 1e-12;
* one dense ``kkt_step`` on two lanes of one IPM state (the second made
  indefinite, so its δ_w ladder climbs): dZ, λ⁺ and δ to 1e-10 and ``ok``
  equal, then ``resolve`` and ``resolve.many``; and the same step with the
  materialized L-BFGS model (``ipm._lbfgs_hessian``, to 1e-12 against the
  JAX package's).

Whole solves against ``tests/golden/torch/dense_e2e.npz`` (made by
``make_dense.py``): the end-to-end fixtures of ``tests/test_riccati.py``
(``:357``, ``:407``, ``:434``) with ``backend="dense"`` — equal iterations
and Z within 1e-8 of the JAX package's dense solve, and the port's Riccati
solve within the tolerance at which ``tests/test_riccati.py`` holds the
JAX package's Riccati solve to its dense one — and L-BFGS on the dense
backend on the cartpole problem of ``tests/test_lbfgs.py:59`` (equal
iterations, Z within 1e-8).
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import directtrajopt_tpu_torch as tdx
import torch_twins as tw
from directtrajopt_tpu.benchmarks import make_cartpole_problem as j_cartpole
from directtrajopt_tpu.solvers import assembly as jasm
from directtrajopt_tpu.solvers import ipm as jipm
from directtrajopt_tpu.solvers.canonical import make_nlp as jmake_nlp
from directtrajopt_tpu.solvers.ops_dense import DenseOps as JDenseOps
from directtrajopt_tpu.solvers.options import IPMOptions as JOptions
from directtrajopt_tpu_torch.benchmarks import make_cartpole_problem as t_cartpole
from directtrajopt_tpu_torch.bridge import from_numpy_problem
from directtrajopt_tpu_torch.solvers import assembly as tasm
from directtrajopt_tpu_torch.solvers import ipm as tipm
from directtrajopt_tpu_torch.solvers.canonical import make_nlp as tmake_nlp
from directtrajopt_tpu_torch.solvers.ops_dense import DenseOps as TDenseOps

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch", "dense_e2e.npz")

ASSEMBLY = {
    "l1_slack": tw.l1_slack,
    "nonlinear_mixed": tw.nonlinear_mixed,
    "globals_border_ineq": lambda: tw.riccati_globals(with_border_ineq=True),
}


def _pair(build):
    jp, fns = build()[:2]
    return jp, from_numpy_problem(jp, "cpu", functions=fns)


def _point(jn, seed=0):
    rng = np.random.default_rng(seed)
    return rng, rng.normal(size=jn.n_eq), rng.normal(size=jn.n_in)


@pytest.mark.parametrize("name", list(ASSEMBLY))
def test_dense_assembly_matches_jax(name):
    jp, tp = _pair(ASSEMBLY[name])
    jn, tn = jmake_nlp(jp), tmake_nlp(tp)
    rng, lam, nu = _point(jn)
    Z = np.asarray(jp.trajectory.to_zvec()) + 0.01 * rng.normal(size=jn.z_dim)
    ref = jax.jit(lambda Z, lam, nu: (
        jasm.jac_eq(jn, Z), jasm.jac_in(jn, Z), jasm.hess_lagrangian(jn, Z, lam, nu, 1.0),
        jasm.hess_lagrangian(jn, Z, lam, nu, 1.0, gauss_newton=True),
    ))(jnp.asarray(Z), jnp.asarray(lam), jnp.asarray(nu))
    Zt, lt, nt = (torch.as_tensor(a)[None] for a in (Z, lam, nu))
    out = (tasm.jac_eq(tn, Zt), tasm.jac_in(tn, Zt), tasm.hess_lagrangian(tn, Zt, lt, nt),
           tasm.hess_lagrangian(tn, Zt, lt, nt, gauss_newton=True))
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a), rtol=0, atol=1e-12)
    for A_j, A_t in ((jn.A_eq, tn.A_eq), (jn.A_in, tn.A_in)):
        np.testing.assert_allclose(A_t.dense(torch.float64)[0].numpy(),
                                   np.asarray(A_j.dense(jnp.float64)), rtol=0, atol=1e-15)


def test_coo_dense_adds_repeated_entries():
    """Repeated (row, col) entries add up, as the JAX package's
    ``.at[].add`` does; each pass places one entry per position."""
    from directtrajopt_tpu_torch.solvers.canonical import COORows

    rows, cols = np.array([0, 1, 0, 0, 2]), np.array([1, 0, 1, 1, 2])
    vals = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0], [0.5, 0.0, 0.25, 0.125, -1.0]])
    out = COORows(rows, cols, vals, 3, 3).dense(torch.float64)
    ref = np.zeros((2, 3, 3))
    for i in range(5):
        ref[:, rows[i], cols[i]] += vals[:, i].numpy()
    np.testing.assert_array_equal(out.numpy(), ref)


def _step_inputs(jn, seed):
    """Two lanes of KKT-step inputs; lane 1's Σ has negative entries, which
    make its condensed Hessian indefinite."""
    rng = np.random.default_rng(seed)
    free = np.asarray(jn.free_mask)
    Sig = np.stack([np.full(jn.z_dim, 0.1), np.where(np.arange(jn.z_dim) % 3 == 0, -50.0, 0.1)])
    Sig = Sig * free
    D = np.full((2, jn.n_in), 0.5)
    g = rng.normal(size=(2, jn.z_dim)) * free
    rhs_c = rng.normal(size=(2, jn.n_eq)) * 0.1
    extra = rng.normal(size=(2, 3, jn.z_dim)) * free, rng.normal(size=(2, 3, jn.n_eq))
    return Sig, D, g, rhs_c, extra


def _jax_step(jn, Z, lam, nu, opt, W=None):
    """The JAX package's dense step on one lane (jitted), its resolve of the
    extra right-hand sides and its δ."""

    @jax.jit
    def step(Sig, D, g, rhs_c, ez, ec):
        ctx = JDenseOps(jn).prepare(Z, lam, nu, skip_hessian=W is not None)
        if W is not None:
            ctx.set_hessian(W)
        dZ, lp, ok, delta, resolve = ctx.kkt_step(Sig, D, g, rhs_c, jnp.zeros(()), opt)
        rz, rl = resolve.many(ez, ec)
        return dZ, lp, ok, delta, rz, rl

    return step


@pytest.mark.parametrize("lbfgs", [False, True], ids=["exact", "lbfgs"])
def test_dense_kkt_step_matches_jax(lbfgs):
    jp, tp = _pair(tw.nonlinear_mixed)
    jn, tn = jmake_nlp(jp), tmake_nlp(tp)
    rng, lam, nu = _point(jn, 1)
    Z = np.asarray(jn.apply_pins(jnp.asarray(jp.trajectory.to_zvec())))
    nu = np.abs(nu)
    Sig, D, g, rhs_c, (ez, ec) = _step_inputs(jn, 2)
    W_j = W_t = None
    if lbfgs:
        m = 4
        S = rng.normal(size=(m, jn.z_dim)) * 0.01
        Y = 2.0 * S + 0.001 * rng.normal(size=(m, jn.z_dim))
        W_j = jipm._lbfgs_hessian(jnp.asarray(S), jnp.asarray(Y), jnp.asarray(m, jnp.int32))
        W_t = tipm._lbfgs_hessian(torch.as_tensor(S)[None].expand(2, m, -1),
                                  torch.as_tensor(Y)[None].expand(2, m, -1),
                                  torch.tensor([m, m], dtype=torch.int32))
        np.testing.assert_allclose(W_t[0].numpy(), np.asarray(W_j), rtol=0, atol=1e-12)
    step = _jax_step(jn, jnp.asarray(Z), jnp.asarray(lam), jnp.asarray(nu), JOptions(), W_j)
    ref = [step(*(jnp.asarray(a[i]) for a in (Sig, D, g, rhs_c, ez, ec))) for i in range(2)]

    two = lambda a: torch.as_tensor(np.broadcast_to(a, (2,) + a.shape).copy())  # noqa: E731
    ctx = TDenseOps(tn).prepare(two(Z), two(lam), two(nu), skip_hessian=lbfgs)
    if lbfgs:
        ctx.set_hessian(W_t)
    dZ, lp, ok, delta, resolve = ctx.kkt_step(
        *(torch.as_tensor(a) for a in (Sig, D, g, rhs_c)), torch.zeros(2, dtype=torch.float64),
        tdx.IPMOptions())
    rz, rl = resolve.many(torch.as_tensor(ez), torch.as_tensor(ec))
    for i in range(2):
        dZ_j, lp_j, ok_j, d_j, rz_j, rl_j = ref[i]
        assert bool(ok[i]) == bool(ok_j)
        assert float(delta[i]) == pytest.approx(float(d_j), rel=1e-12)
        for t, j in ((dZ[i], dZ_j), (lp[i], lp_j), (rz[i], rz_j), (rl[i], rl_j)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-10)
    assert float(delta[0]) == 0.0 and float(delta[1]) > 0.0  # lane 1 climbed the ladder


@pytest.mark.parametrize("name", list(tw.E2E))
def test_e2e_dense_solve_matches_jax(name):
    """The dense solve against the JAX package's (equal iterations, Z to
    1e-8), and the port's Riccati solve against it at the tolerance of
    ``tests/test_riccati.py``."""
    g = np.load(GOLDEN)
    build, (what, tol) = tw.E2E[name]
    jp, fns, kw = build()
    tp = from_numpy_problem(jp, "cpu", functions=fns)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rd = tdx.solve(tp, backend="dense", **kw)
        rr = tdx.solve(tp, backend="riccati", **kw)
    assert bool(rd.converged[0]) == bool(g[f"converged_{name}"]) and bool(rr.converged[0])
    assert int(rd.iterations[0]) == int(g[f"iterations_{name}"])
    Zd = rd.problem.trajectory.to_zvec()[0].numpy()
    np.testing.assert_allclose(Zd, g[f"Z_{name}"], rtol=0, atol=1e-8)
    if what == "objective":
        np.testing.assert_allclose(float(rr.objective[0]), float(rd.objective[0]), rtol=tol)
    else:
        np.testing.assert_allclose(rr.problem.trajectory.to_zvec()[0].numpy(), Zd, atol=tol)


def test_dense_lbfgs_matches_jax():
    """``tests/test_lbfgs.py:59``'s cartpole (N=30, m = 10, tol 1e-5) with
    L-BFGS on the dense backend: equal iterations, Z to 1e-8."""
    g = np.load(GOLDEN)
    jp = j_cartpole(N=30, seed=0)
    tp = t_cartpole(N=30, seed=0, device="cpu")
    np.testing.assert_array_equal(tp.trajectory.to_zvec()[0].numpy(),
                                  np.asarray(jp.trajectory.to_zvec()))
    res = tdx.solve(tp, backend="dense", tol=1e-5, max_iter=300, hessian_approximation="lbfgs",
                    limited_memory_max_history=10)
    assert bool(res.converged[0]) and bool(g["converged_lbfgs"])
    assert int(res.iterations[0]) == int(g["iterations_lbfgs"])
    np.testing.assert_allclose(res.problem.trajectory.to_zvec()[0].numpy(), g["Z_lbfgs"],
                               rtol=0, atol=1e-8)
