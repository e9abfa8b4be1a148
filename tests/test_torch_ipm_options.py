"""The IPM options that change one rule of the method, in the port against
the JAX package.

* ``mu_strategy`` "mehrotra" / "adaptive", ``ls_memory=4`` and
  ``dual_init="least_squares"`` on the N=7 bilinear fixture of
  ``tests/test_refine.py::test_mu_strategies_f32_under_x64`` (free time,
  feasible start; lanes from seeds 0 and 1), float64, tol 1e-8, against the
  JAX package's solves stored by ``tests/golden/torch/make_lbfgs_cartpole.py``
  (``ipm_options_n7.npz``). ``ls_memory`` and ``least_squares``: per-lane
  iterations equal and Z within 1e-8. Mehrotra and adaptive grind on this
  fixture for 60-100 iterations, and their paths drift apart from the
  rounding level (1e-16 at the first row) by a factor of 3-10 an iteration
  in both packages alike, until the iteration counts differ by a few
  (measured: Mehrotra 94/79 iterations in JAX, 93/81 in the port; adaptive
  61/89 and 61/99; every lane converged in both). They are held as
  ``tests/test_torch_callbacks.py`` holds the monotone rule, on their first
  12 iterations: every row of the telemetry ring within rtol 1e-8 / atol
  1e-12 (measured worst 3e-10 relative).
* ``refine_residuals`` on ``test_refine.py``'s fixtures, the port alone:
  the float32 strict fixture (N=11, seed 5, tol 1e-6) converges with an
  external float64 KKT check below 5e-6; on float64 the option is bitwise a
  no-op; and the shift of the right-hand side by Jᵀλ that it relies on
  leaves dZ unchanged and returns the multiplier increment.
"""

import os

import numpy as np
import pytest
import torch
from torch.func import grad, vjp

import directtrajopt_tpu_torch as tdx
from directtrajopt_tpu_torch import benchmarks as tbench
from directtrajopt_tpu_torch.module import tree_map
from directtrajopt_tpu_torch.solvers.canonical import make_nlp
from directtrajopt_tpu_torch.solvers.ops_riccati import RiccatiOps

torch.set_num_threads(1)

GOLDEN_OPTIONS = os.path.join(os.path.dirname(__file__), "golden", "torch", "ipm_options_n7.npz")
OPTIONS = {"mehrotra": dict(mu_strategy="mehrotra"), "adaptive": dict(mu_strategy="adaptive"),
           "ls_memory": dict(ls_memory=4), "least_squares": dict(dual_init="least_squares")}
TELE_ROWS = 12
TELE_RTOL, TELE_ATOL = 1e-8, 1e-12


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN_OPTIONS)


def _fixture(seeds, dtype=torch.float64, N=7):
    probs = [tbench.make_bilinear_problem(N=N, seed=s, free_time=True, feasible_start=True,
                                          device="cpu", dtype=dtype) for s in seeds]
    return tree_map(lambda *xs: torch.cat(xs), *probs)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax(golden, name):
    g = golden
    seeds = [int(s) for s in g["seeds"]]
    kw = dict(tol=1e-8, max_iter=100)
    assert repr(kw) == str(g["options"])
    assert g[f"converged_{name}"].all()
    if name in ("ls_memory", "least_squares"):
        r = tdx.solve_batch(_fixture(seeds), **kw, **OPTIONS[name])
        assert r.converged.all()
        np.testing.assert_array_equal(r.iterations.numpy(), g[f"iterations_{name}"])
        np.testing.assert_allclose(r.problem.trajectory.to_zvec().numpy(), g[f"Z_{name}"],
                                   rtol=0, atol=1e-8)
    else:
        r = tdx.solve_batch(_fixture(seeds), callbacks=tdx.telemetry(TELE_ROWS),
                            **dict(kw, max_iter=TELE_ROWS), **OPTIONS[name])
        assert (r.iterations == TELE_ROWS).all()
        np.testing.assert_allclose(r.ipm.history_stats.numpy(),
                                   g[f"tele_{name}"][:, :TELE_ROWS], rtol=TELE_RTOL,
                                   atol=TELE_ATOL)
    if name == "ls_memory":
        assert r.ipm.state.phi_hist.shape == (len(seeds), 4)


def _external_kkt(problem, res):
    """Float64 KKT residuals at the solve's best iterate and its matched
    duals, per lane (max |∇L| on free coordinates, max primal violation)."""
    nlp = make_nlp(tdx.cast_problem(problem, torch.float64))
    st = res.ipm.state
    Z = st.best_kkt_Z.to(torch.float64)
    w = tree_map(lambda x: x.to(torch.float64), st.best_kkt_warm)
    gf = grad(lambda z: nlp.objective(z).sum())(Z)
    _, vjp_e = vjp(nlp.c_eq, Z)
    r = nlp.free_mask * (gf + vjp_e(w.lam)[0] - w.zL + w.zU)
    assert nlp.n_in == 0
    return r.abs().amax(-1), nlp.c_eq(Z).abs().amax(-1)


def test_refine_f32_strict_convergence_external_kkt():
    prob = tdx.cast_problem(_fixture([5], N=11), torch.float32)
    res = tdx.solve(prob, refine_residuals=True, tol=1e-6, acceptable_tol=1e-6,
                    acceptable_iter=100, max_iter=400, mu_init=3e-2)
    assert res.ipm.Z.dtype == torch.float32
    assert bool(res.converged[0]), float(res.kkt_error[0])
    du, pr = _external_kkt(prob, res)
    assert float(du[0]) < 5e-6 and float(pr[0]) < 5e-6, (float(du[0]), float(pr[0]))


def test_refine_noop_on_f64():
    prob = _fixture([2])
    kw = dict(tol=1e-8, acceptable_tol=1e-8, max_iter=15, mu_init=1e-1)
    a = tdx.solve(prob, refine_residuals=False, **kw)
    b = tdx.solve(prob, refine_residuals=True, **kw)
    assert torch.equal(a.kkt_error, b.kkt_error)
    assert torch.equal(a.ipm.Z, b.ipm.Z)


def test_incremental_multiplier_identity():
    """Shifting the right-hand side by Jᵀλ leaves dZ unchanged and turns the
    multiplier output into Δλ = λ⁺ − λ (the refined solve's form)."""
    prob = tbench.make_bilinear_problem(N=7, seed=3, free_time=True, feasible_start=True,
                                        device="cpu")
    nlp = make_nlp(prob)
    rng = np.random.default_rng(1)
    Z = nlp.apply_pins(torch.as_tensor(rng.normal(size=(1, nlp.z_dim)) * 0.1))
    lam = torch.as_tensor(rng.normal(size=(1, nlp.n_eq)) * 0.5)
    nu = torch.zeros((1, 0), dtype=torch.float64)
    ctx = RiccatiOps(nlp).prepare(Z, lam, nu)
    Sig = torch.full((1, nlp.z_dim), 0.3, dtype=torch.float64) * nlp.free_mask
    g = torch.as_tensor(rng.normal(size=(1, nlp.z_dim))) * nlp.free_mask
    rc = torch.as_tensor(rng.normal(size=(1, nlp.n_eq)))
    opt, zero = tdx.IPMOptions(), torch.zeros(1, dtype=torch.float64)
    dZ1, lp1, ok1, _, _ = ctx.kkt_step(Sig, nu, g, -rc, zero, opt)
    dZ2, lp2, ok2, _, _ = ctx.kkt_step(Sig, nu, g + nlp.free_mask * ctx.JeT(lam), -rc, zero, opt)
    assert bool(ok1[0]) and bool(ok2[0])
    assert float((dZ1 - dZ2).abs().max()) < 1e-6
    assert float(((lam + lp2) - lp1).abs().max()) < 1e-5

