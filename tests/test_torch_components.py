"""Components of the port's main path against the JAX package, at small sizes.

Every comparison feeds both packages the same inputs (problems built by the
same seeded builders or carried across by ``bridge``; perturbations drawn
with numpy). Bounds: bit equality for the data layer and the error-free
transforms; 1e-12 (f64) for values and derivatives; 1e-10 (f64) for one
KKT step, whose δ_w ladder and Schur border add a few condition numbers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directtrajopt_tpu import benchmarks as jbench
from directtrajopt_tpu.integrators import base as jbase
from directtrajopt_tpu.ops.expm import expv_taylor as j_expv
from directtrajopt_tpu.solvers import ipm as jipm
from directtrajopt_tpu.solvers.assembly import gradient as j_gradient
from directtrajopt_tpu.solvers.canonical import make_nlp as j_make_nlp
from directtrajopt_tpu.solvers.ops_riccati import RiccatiOps as JRiccatiOps
from directtrajopt_tpu.solvers.options import IPMOptions as JIPMOptions
from directtrajopt_tpu_torch import benchmarks as tbench
from directtrajopt_tpu_torch.bridge import from_numpy_problem, from_numpy_warm
from directtrajopt_tpu_torch.integrators import base as tbase
from directtrajopt_tpu_torch.ops.expm import expv_taylor as t_expv
from directtrajopt_tpu_torch.solvers import ipm as tipm
from directtrajopt_tpu_torch.solvers.assembly import gradient as t_gradient
from directtrajopt_tpu_torch.solvers.canonical import make_nlp as t_make_nlp
from directtrajopt_tpu_torch.solvers.ops_riccati import RiccatiOps as TRiccatiOps
from directtrajopt_tpu_torch.solvers.options import IPMOptions as TIPMOptions

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    """One N=11 bilinear problem in both packages, and a perturbed Z."""
    jp = jbench.make_bilinear_problem(N=11, feasible_start=True, taylor_order=6)
    tp = from_numpy_problem(jp, "cpu")
    rng = np.random.default_rng(0)
    Z = np.asarray(jp.trajectory.to_zvec()) + 1e-2 * rng.standard_normal(tp.trajectory.layout.z_dim)
    return jp, tp, Z


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1.0) if a.size else 0.0
    assert err < tol, err


# ---------------- data layer ------------------------------------------------ #


def test_layout_and_zvec_bit_equal():
    jp = jbench.make_batched_bilinear_problems(3, N=51, feasible_start=True, taylor_order=6)
    tp = tbench.make_batched_bilinear_problems(3, N=51, feasible_start=True, taylor_order=6,
                                               device="cpu")
    bp = from_numpy_problem(jp, "cpu")
    jl, tl = jp.trajectory.layout, tp.trajectory.layout
    assert (tl.names, tl.dims, tl.N, tl.timestep, tl.dim, tl.z_dim) == (
        jl.names, jl.dims, jl.N, jl.timestep, jl.dim, jl.z_dim)
    assert tl.offsets == jl.offsets
    assert all(tl.comp_slice(n) == jl.comp_slice(n) for n in tl.names)
    Zj = np.asarray(jp.trajectory.to_zvec())
    assert np.array_equal(tp.trajectory.to_zvec().numpy(), Zj)
    assert np.array_equal(bp.trajectory.to_zvec().numpy(), Zj)
    back = tp.trajectory.from_zvec(tp.trajectory.to_zvec())
    assert all(torch.equal(back.data[n], tp.trajectory.data[n]) for n in tl.names)


def test_single_problem_builder_bit_equal():
    jp = jbench.make_bilinear_problem(N=21, seed=3, feasible_start=False)
    tp = tbench.make_bilinear_problem(N=21, seed=3, feasible_start=False, device="cpu")
    assert np.array_equal(tp.trajectory.to_zvec().numpy()[0], np.asarray(jp.trajectory.to_zvec()))


def test_canonical_pins_and_bounds_equal(pair):
    jp, tp, _ = pair
    jn, tn = j_make_nlp(jp), t_make_nlp(tp)
    own = t_make_nlp(tbench.make_bilinear_problem(N=11, feasible_start=True, taylor_order=6,
                                                  device="cpu"))
    for n in (tn, own):
        assert np.array_equal(n.fix_idx, jn.fix_idx)
        assert np.array_equal(n.fix_val.numpy()[0], np.asarray(jn.fix_val))
        assert np.array_equal(n.lb.numpy()[0], np.asarray(jn.lb))
        assert np.array_equal(n.ub.numpy()[0], np.asarray(jn.ub))
        assert np.array_equal(n.free_mask.numpy(), np.asarray(jn.free_mask))
        assert (n.n_dyn, n.n_eq, n.n_in) == (jn.n_dyn, jn.n_eq, jn.n_in)


def test_default_timestep_bound_injected():
    """A free timestep with no bounds gets Δt ≥ 0 (with a warning)."""
    from directtrajopt_tpu_torch import DirectTrajOptProblem, QuadraticRegularizer, Trajectory

    traj = Trajectory.create({"u": np.zeros((5, 1)), "dt": np.full((5, 1), 0.1)},
                             timestep="dt", device="cpu")
    with pytest.warns(UserWarning, match="no bounds"):
        prob = DirectTrajOptProblem.create(traj, QuadraticRegularizer.create("u", traj, 1.0), ())
    lb, ub = prob.trajectory.bounds["dt"]
    assert lb.tolist() == [[0.0]] and ub.tolist() == [[float("inf")]]


# ---------------- values and derivatives ------------------------------------ #


def test_expv_taylor_matches():
    rng = np.random.default_rng(1)
    A = 0.3 * rng.standard_normal((3, 7, 4, 4))
    x = rng.standard_normal((3, 7, 4))
    ref = jax.vmap(jax.vmap(lambda a, v: j_expv(a, v, order=12)))(jnp.asarray(A), jnp.asarray(x))
    _close(ref, t_expv(torch.as_tensor(A), torch.as_tensor(x), order=12), 1e-12)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_integrator_residuals_and_derivatives(pair, which):
    jp, tp, Z = pair
    layout = jp.trajectory.layout
    ji, ti = jp.integrators[which], tp.integrators[which]
    zmat = Z.reshape(layout.N, layout.dim)
    zt = torch.as_tensor(zmat)[None]
    _close(jbase.stack_residuals(ji, layout, jnp.asarray(zmat)),
           tbase.stack_residuals(ti, tp.trajectory.layout, zt)[0], 1e-12)
    _close(jbase.stack_jacobians_zk(ji, layout, jnp.asarray(zmat)),
           tbase.stack_jacobians_zk(ti, tp.trajectory.layout, zt)[0], 1e-12)
    r = ji.residual_dim(layout)
    mu = np.random.default_rng(2).standard_normal((layout.N - 1, r))
    _close(jbase.stack_hessians_zk(ji, layout, jnp.asarray(zmat), jnp.asarray(mu)),
           tbase.stack_hessians_zk(ti, tp.trajectory.layout, zt, torch.as_tensor(mu)[None])[0],
           1e-12)


def test_nlp_functions_match(pair):
    jp, tp, Z = pair
    jn, tn = j_make_nlp(jp), t_make_nlp(tp)
    Zj, Zt = jnp.asarray(Z), torch.as_tensor(Z)[None]
    _close(jn.objective(Zj), tn.objective(Zt)[0], 1e-12)
    _close(j_gradient(jn, Zj), t_gradient(tn, Zt)[0], 1e-12)
    _close(jn.c_eq(Zj), tn.c_eq(Zt)[0], 1e-12)
    _close(jn.c_eq_l1(Zj), tn.c_eq_l1(Zt)[0], 1e-12)
    assert np.array_equal(np.asarray(jn.apply_pins(Zj)), tn.apply_pins(Zt)[0].numpy())
    # the trial-grid form: extra axes broadcast against the lane's data
    Z3 = torch.stack([Zt, 2 * Zt, Zt - 1], dim=1)
    assert torch.equal(tn.c_eq_l1(Z3)[:, 1], tn.c_eq_l1(2 * Zt))


@pytest.fixture(scope="module")
def jax_kkt(pair):
    """JAX prepare + kkt_step + two-RHS resolve, jitted once per Hessian mode."""
    jn = j_make_nlp(pair[0])

    def make(gauss_newton):
        def step(Z, lam, Sig, g_hat, rhs_c, delta_last, rz2, rc2):
            ctx = JRiccatiOps(jn, pallas_mode="never").prepare(
                Z, lam, jnp.zeros(0), gauss_newton=gauss_newton)
            out = ctx.kkt_step(Sig, jnp.zeros(0), g_hat, rhs_c, delta_last,
                               JIPMOptions().astype(jnp.float64))
            return out[:4], out[4].many(rz2, rc2), ctx.JeT(lam)

        return jax.jit(step)

    return {gn: make(gn) for gn in (False, True)}


@pytest.mark.parametrize("gauss_newton", [False, True])
@pytest.mark.parametrize("lam_scale,delta_last", [(0.1, 0.0), (30.0, 1e-3)])
def test_kkt_step_matches(pair, jax_kkt, gauss_newton, lam_scale, delta_last):
    """One Riccati KKT step (dZ, λ⁺, ok, δ) and a two-RHS resolve."""
    jp, tp, Z = pair
    jn, tn = j_make_nlp(jp), t_make_nlp(tp)
    rng = np.random.default_rng(3)
    free = np.asarray(jn.free_mask)
    lam = lam_scale * rng.standard_normal(jn.n_eq)
    Sig = np.abs(rng.standard_normal(jn.z_dim)) * free
    g_hat = rng.standard_normal(jn.z_dim) * free
    rhs_c = rng.standard_normal(jn.n_eq)
    rz2 = rng.standard_normal((2, jn.z_dim)) * free
    rc2 = rng.standard_normal((2, jn.n_eq))

    jout, (jdz, jlam), jJeT = jax_kkt[gauss_newton](
        *map(jnp.asarray, (Z, lam, Sig, g_hat, rhs_c, delta_last, rz2, rc2)))
    tctx = TRiccatiOps(tn).prepare(torch.as_tensor(Z)[None], torch.as_tensor(lam)[None],
                                   torch.zeros((1, 0), dtype=torch.float64),
                                   gauss_newton=gauss_newton)
    tout = tctx.kkt_step(torch.as_tensor(Sig)[None], torch.zeros((1, 0), dtype=torch.float64),
                         torch.as_tensor(g_hat)[None], torch.as_tensor(rhs_c)[None],
                         torch.tensor([delta_last], dtype=torch.float64),
                         TIPMOptions().astype(torch.float64))
    _close(jout[0], tout[0][0], 1e-10)
    _close(jout[1], tout[1][0], 1e-10)
    assert bool(jout[2]) == bool(tout[2][0])
    assert float(jout[3]) == pytest.approx(float(tout[3][0]), rel=1e-12)
    tdz, tlam = tout[4].many(torch.as_tensor(rz2)[None], torch.as_tensor(rc2)[None])
    _close(jdz, tdz[0], 1e-10)
    _close(jlam, tlam[0], 1e-10)
    _close(jJeT, tctx.JeT(torch.as_tensor(lam)[None])[0], 1e-12)


# ---------------- solver pieces ---------------------------------------------- #


def test_error_free_transforms_bit_equal():
    rng = np.random.default_rng(4)
    a, b, c = (rng.standard_normal(257).astype(np.float32) * 10.0 ** rng.integers(-3, 3, 257)
               for _ in range(3))
    ja, jb, jc = map(jnp.asarray, (a, b, c))
    ta, tb, tc = map(torch.as_tensor, (a, b, c))
    for x, y in zip(jipm._two_sum(ja, jb), tipm._two_sum(ta, tb)):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert np.array_equal(np.asarray(jipm._csum([ja, jb, jc])), tipm._csum([ta, tb, tc]).numpy())
    for x, y in zip(jipm._two_prod_f32(ja, jb), tipm._two_prod_f32(ta, tb)):
        assert np.array_equal(np.asarray(x), y.numpy())


def test_options_mirror_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JIPMOptions)}
    tf = {f.name: f.default for f in dataclasses.fields(TIPMOptions)}
    assert tf == jf


@pytest.mark.parametrize("kw", [
    dict(mu_strategy="mehrotra"),
    dict(mu_strategy="adaptive"),
    dict(hessian_approximation="limited-memory"),
    dict(hessian_approximation="lbfgs"),
    dict(hessian_regularization="project"),
    dict(hessian_regularization="stagewise"),
    dict(hessian_regularization="flip"),
    dict(hessian_regularization="floor"),
    dict(refine_residuals=True),
    dict(ls_memory=2),
])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TIPMOptions(**kw).check_supported()


def test_masked_min_of_empty_mask():
    x = torch.tensor([[3.0, -1.0], [2.0, 5.0]])
    mask = torch.tensor([[False, True], [False, False]])
    assert tipm._masked_min(x, mask, 1.0).tolist() == [-1.0, 1.0]


def test_bridge_warm_start():
    jp = jbench.make_batched_bilinear_problems(2, N=7, feasible_start=True)
    n = j_make_nlp(jax.tree.map(lambda x: x[0], jp))
    warm = jipm.WarmStart(s=jnp.zeros((2, 0)), lam=jnp.ones((2, n.n_eq)), nu=jnp.zeros((2, 0)),
                          zL=jnp.full((2, n.z_dim), 0.5), zU=jnp.zeros((2, n.z_dim)))
    tw = from_numpy_warm(warm, "cpu")
    assert tw.lam.shape == (2, n.n_eq) and tw.zL.dtype == torch.float64
    assert float(tw.zL[1, 3]) == 0.5
