"""The port's constraint stack against the JAX package, at small sizes.

Every problem is built once in the JAX package (``tests/torch_twins.py``)
and carried across by ``bridge.from_numpy_problem``; perturbations are drawn
with numpy. Bounds: bit equality for the canonical rows and the static
Riccati structure; 1e-12 (f64) for residuals, Jacobians, objective values,
gradients and knot Hessians; 1e-10 (f64) for one KKT step, whose δ_w ladder
and Schur border add a few condition numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

import directtrajopt_tpu as dtx
import directtrajopt_tpu_torch as tdx
from directtrajopt_tpu.constraints.base import LinearCanon as JCanon
from directtrajopt_tpu.solvers.canonical import make_nlp as j_make_nlp
from directtrajopt_tpu.solvers.ops_riccati import RiccatiOps as JRiccatiOps
from directtrajopt_tpu.solvers.ops_riccati import analyze as j_analyze
from directtrajopt_tpu.solvers.options import IPMOptions as JIPMOptions
from directtrajopt_tpu_torch.bridge import from_numpy_problem
from directtrajopt_tpu_torch.constraints import LinearCanon as TCanon
from directtrajopt_tpu_torch.objectives import knot_hvp
from directtrajopt_tpu_torch.solvers.canonical import make_nlp as t_make_nlp
from directtrajopt_tpu_torch.solvers.ops_riccati import RiccatiOps as TRiccatiOps
from directtrajopt_tpu_torch.solvers.ops_riccati import _knot_hessians
from directtrajopt_tpu_torch.solvers.ops_riccati import analyze as t_analyze
from directtrajopt_tpu_torch.solvers.options import IPMOptions as TIPMOptions
from torch_twins import PROBLEMS, feasible_bilinear_traj, promotion

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX problem, port problem, JAX NLP, port NLP)."""
    out = {}
    for name, build in PROBLEMS.items():
        jp, fns = build()
        tp = from_numpy_problem(jp, "cpu", functions=fns)
        out[name] = (jp, tp, j_make_nlp(jp), t_make_nlp(tp))
    return out


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1.0) if a.size else 0.0
    assert err < tol, err


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))[None]


# ---------------- canonical rows and structure ------------------------------- #


def _free_time_traj():
    """A free-time trajectory with x (2), u (1), dt and t components."""
    traj, _ = feasible_bilinear_traj(N=9)
    data = dict(traj.data)
    data["dt"] = np.full((9, 1), 0.15)
    data["t"] = np.arange(9.0)[:, None] * 0.15
    return dtx.Trajectory.create(data, timestep="dt", controls="u")


@pytest.mark.parametrize("which", [
    "all_equal_u", "timesteps_all_equal", "total_u", "duration", "duration_range",
    "duration_ub", "symmetry_odd", "symmetric_control", "time_consistency", "l1_slack_times",
])
def test_linear_lowering_bit_equal(which):
    """Every linear class lowers to the same COO rows, coefficients and
    right-hand sides (and the same promotability: numpy vs tensor values)."""
    jt = _free_time_traj()
    tt = from_numpy_problem(dtx.DirectTrajOptProblem.create(
        jt, dtx.QuadraticRegularizer.create("u", jt, 1.0), []), "cpu").trajectory
    # (package, its trajectory, kwargs only the port takes): TotalConstraint
    # and DurationConstraint take the trajectory (lanes, device) in the port
    make = {
        "all_equal_u": lambda m, tr, kw: m.AllEqualConstraint(name="u"),
        "timesteps_all_equal": lambda m, tr, kw: m.TimeStepsAllEqualConstraint(),
        "total_u": lambda m, tr, kw: m.TotalConstraint.create("u", 0.7, **kw),
        "duration": lambda m, tr, kw: m.DurationConstraint(1.2, **kw),
        "duration_range": lambda m, tr, kw: m.DurationConstraint(lb=1.0, ub=1.4, **kw),
        "duration_ub": lambda m, tr, kw: m.DurationConstraint(ub=1.4, **kw),
        "symmetry_odd": lambda m, tr, kw: m.SymmetryConstraint.create("x", [1], even=False),
        "symmetric_control": lambda m, tr, kw: m.SymmetricControlConstraint("u", [0]),
        "time_consistency": lambda m, tr, kw: m.TimeConsistencyConstraint(timestep_name="dt"),
        "l1_slack_times": lambda m, tr, kw: m.L1SlackConstraint.create("u", "dt", tr, times=[1, 4]),
    }[which]
    jc, tc = JCanon(z_dim=jt.layout.z_dim), TCanon(z_dim=tt.layout.z_dim, B=1)
    make(dtx, jt, {}).lower(jt.layout, jc)
    make(tdx, tt, {"traj": tt}).lower(tt.layout, tc)
    for jrows, trows in ((jc.eq_rows, tc.eq_rows), (jc.ineq_rows, tc.ineq_rows)):
        assert len(jrows) == len(trows)
        for (jr, jcols, jv, jb, jn), (tr, tcols, tv, tb, tn) in zip(jrows, trows):
            assert jn == tn and np.array_equal(jr, tr) and np.array_equal(jcols, tcols)
            assert isinstance(jv, np.ndarray) == isinstance(tv, np.ndarray)
            assert np.array_equal(np.asarray(jv), np.asarray(tv))
            assert np.array_equal(np.asarray(jb), np.asarray(tb)[0])


def test_time_consistency_injected():
    """A 't' component with a free timestep gets t_{k+1} = t_k + Δt_k and,
    without an initial value, t_0 = 0 — as in the JAX package."""
    jt = _free_time_traj()
    jp = dtx.DirectTrajOptProblem.create(jt, dtx.QuadraticRegularizer.create("u", jt, 1.0), [])
    tt = from_numpy_problem(jp, "cpu").trajectory
    tp = tdx.DirectTrajOptProblem.create(tt, tdx.QuadraticRegularizer.create("u", tt, 1.0), ())
    assert [type(c).__name__ for c in tp.constraints] == [type(c).__name__ for c in jp.constraints]
    jn, tn = j_make_nlp(jp), t_make_nlp(tp)
    assert np.array_equal(jn.fix_idx, tn.fix_idx) and tn.n_lin_eq == jn.n_lin_eq == 8


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_analyze_fields_bit_equal(pairs, name):
    _, _, jn, tn = pairs[name]
    js, ts = j_analyze(jn), t_analyze(tn)
    for f in ("s_idx", "v_idx", "core_mask", "promo_jr", "core_beta", "lin_border_rows",
              "bp_steps", "bp_flat", "dyn_flat_of_stack", "in_knot", "in_slot", "m_in",
              "ib_flat", "in_fast_mask", "lin_nnz_keep", "nl_eq_offsets", "nl_in_offsets"):
        assert np.array_equal(np.asarray(getattr(js, f)), np.asarray(getattr(ts, f))), f
    for a, b in zip(js.lin_in_nnz, ts.lin_in_nnz):
        assert np.array_equal(a, b)


def test_promotion_structure():
    """``tests/test_promotion.py``'s structural facts hold in the port."""
    for N in (11, 31):
        S = t_analyze(t_make_nlp(from_numpy_problem(promotion(N)[0], "cpu")))
        assert S.promo_jr.shape[1] == 1 and 4 in S.s_idx
        assert len(S.lin_border_rows) == 0 and len(S.bp_steps) == 2
    S = t_analyze(t_make_nlp(from_numpy_problem(promotion(13, pin_t=True)[0], "cpu")))
    assert S.promo_jr.shape[1] == 1 and len(S.bp_steps) == 3


# ---------------- residuals, Jacobians, objectives -------------------------- #

_NEW_CLASSES = ["time_consistency", "timesteps_all_equal", "duration", "duration_range",
                "symmetry", "l1_slack", "state_constrained", "nonlinear_mixed"]


@pytest.mark.parametrize("name", _NEW_CLASSES)
def test_residuals_and_jacobians_match(pairs, name):
    """c_eq, c_in, Σ|c_eq| and the Jacobians of c_eq / c_in at a random Z."""
    jp, tp, jn, tn = pairs[name]
    Z = np.asarray(jp.trajectory.to_zvec()) + 1e-2 * np.random.default_rng(0).standard_normal(jn.z_dim)

    @jax.jit
    def ref(Z):
        return jn.c_eq(Z), jn.c_in(Z), jn.c_eq_l1(Z), jax.jacfwd(jn.c_eq)(Z), jax.jacfwd(jn.c_in)(Z)

    jce, jci, jl1, jJe, jJi = ref(jnp.asarray(Z))
    Zt = _t(Z)
    _close(jce, tn.c_eq(Zt)[0], 1e-12)
    _close(jci, tn.c_in(Zt)[0], 1e-12)
    _close(jl1, tn.c_eq_l1(Zt)[0], 1e-12)
    _close(jJe, jacfwd(lambda z: tn.c_eq(z[None])[0])(Zt[0]), 1e-12)
    _close(jJi, jacfwd(lambda z: tn.c_in(z[None])[0])(Zt[0]), 1e-12)
    # the trial-grid form: extra axes broadcast against the lane's data
    Z3 = torch.stack([Zt, 2 * Zt], dim=1)
    assert torch.equal(tn.c_in(Z3)[:, 1], tn.c_in(2 * Zt))


def test_nonlinear_convention_and_dim():
    """``create`` on the port's own trajectory detects the calling
    convention and g_dim as the JAX package does."""
    jt, _ = feasible_bilinear_traj(N=6)
    tt = from_numpy_problem(dtx.DirectTrajOptProblem.create(
        jt, dtx.QuadraticRegularizer.create("u", jt, 1.0), []), "cpu").trajectory
    cases = [
        (lambda x, u: jnp.array([x[0] * u[0], x[1], 1.0]),
         lambda x, u: torch.stack([x[0] * u[0], x[1], torch.ones_like(x[1])]), None),
        (lambda z: jnp.array([z[0] + z[2]]), lambda z: (z[0] + z[2]).reshape(1), None),
        (lambda x, u, p: jnp.array([x[0] - p[0], u[0] * p[1]]),
         lambda x, u, p: torch.stack([x[0] - p[0], u[0] * p[1]]),
         [np.array([0.1 * t, 2.0]) for t in range(6)]),
    ]
    for jg, tg, params in cases:
        jc = dtx.NonlinearKnotPointConstraint.create(jg, ["x", "u"], jt, params, equality=False)
        tc = tdx.NonlinearKnotPointConstraint.create(tg, ["x", "u"], tt, params, equality=False)
        assert (tc.convention, tc.g_dim, tc.times) == (jc.convention, jc.g_dim, jc.times)
        zmat = np.asarray(jt.knot_matrix())
        _close(jc.evaluate_flat(jt), tc.evaluate_flat(tt.layout, torch.as_tensor(zmat)[None])[0],
               1e-12)


@pytest.mark.parametrize("name,term", [
    ("l1_slack", 1),  # LinearRegularizer
    ("minimum_time", 1),  # MinimumTimeObjective
    ("nonlinear_mixed", 1),  # TerminalObjective
    ("nonlinear_mixed", 2),  # KnotPointObjective with per-knot parameters
])
def test_objective_value_gradient_knot_hessian(pairs, name, term):
    jp, tp, _, _ = pairs[name]
    jo, to = jp.objective.objectives[term], tp.objective.objectives[term]
    jl, tl = jp.trajectory.layout, tp.trajectory.layout
    N, d = jl.N, jl.dim
    zmat = np.asarray(jp.trajectory.knot_matrix()) + 1e-1 * np.random.default_rng(1).standard_normal((N, d))
    g = jnp.zeros((0,))

    @jax.jit
    def ref(zm):
        def total(zm):
            return jnp.sum(jax.vmap(lambda z, k: jo.cost_at_knot(jl, z, g, k))(zm, jnp.arange(N)))

        hess = jax.vmap(jax.hessian(lambda z, k: jo.cost_at_knot(jl, z, g, k)))(zm, jnp.arange(N))
        return total(zm), jax.grad(total)(zm), hess

    jv, jg, jh = ref(jnp.asarray(zmat))
    zt = torch.as_tensor(zmat)[None]
    _close(jv, to.cost_at_knot(tl, zt).sum(), 1e-12)
    _close(jg, torch.func.grad(lambda z: to.cost_at_knot(tl, z).sum())(zt)[0], 1e-12)
    th = _knot_hessians(to, tl, zt)[0]
    _close(jh, th, 1e-12)
    # the per-knot HVP is the knot Hessian applied to a tangent
    v = torch.as_tensor(np.random.default_rng(2).standard_normal((1, N, d)))
    _close(torch.einsum("nij,nj->ni", th, v[0]), knot_hvp(to, tl, zt, v)[0], 1e-12)


def test_hvp_carriers():
    A = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 3, 4)))
    core = torch.eye(3, dtype=torch.float64).expand(2, 3, 3) * 2.0
    c = tdx.ConstantLowRankHVP(A=A, core=core)
    v = torch.ones((2, 4), dtype=torch.float64)
    torch.testing.assert_close(c.apply(v), torch.einsum("bij,bj->bi", c.materialize(), v))
    assert tdx.CustomKnotHVP(apply_fn=lambda x: 3 * x).apply(v).sum() == 24.0


# ---------------- one KKT step ----------------------------------------------- #

_MODES = (False, "stagewise", "project", "flip")
_KKT = [
    # (problem, every hessian_regularization mode?): the modes on fast
    # nonlinear inequality rows with pinned-target border rows
    ("time_consistency", False), ("timesteps_all_equal_promotion", False),
    ("pinned_final_t", False), ("minimum_time", False), ("timesteps_all_equal", False),
    ("duration", False), ("duration_range", False), ("symmetry", False), ("l1_slack", False),
    ("state_constrained", True), ("nonlinear_mixed", False),
]


@pytest.mark.parametrize("name,all_modes", _KKT)
def test_kkt_step_matches(pairs, name, all_modes):
    """dZ, λ⁺, ν⁺ (through ds = −(c_i+s) − J_i dZ), ok and δ of one Riccati
    KKT step, and the J_eqᵀ / J_inᵀ / J_in matvecs, at random iterates."""
    jp, tp, jn, tn = pairs[name]
    modes = _MODES if all_modes else _MODES[:1]
    rng = np.random.default_rng(3)
    free = np.asarray(jn.free_mask)
    Z = np.asarray(jp.trajectory.to_zvec()) + 1e-2 * rng.standard_normal(jn.z_dim)
    lam = 0.3 * rng.standard_normal(jn.n_eq)
    s = np.abs(rng.standard_normal(jn.n_in)) + 0.1
    nu = np.abs(rng.standard_normal(jn.n_in)) + 0.1
    Sig = np.abs(rng.standard_normal(jn.z_dim)) * free
    g_hat = rng.standard_normal(jn.z_dim) * free
    rhs_c = rng.standard_normal(jn.n_eq)
    vin = rng.standard_normal(jn.n_in)
    D = nu / s
    opt = JIPMOptions().astype(jnp.float64)

    @jax.jit
    def ref(Z, lam, nu, Sig, D, g_hat, rhs_c, vin):
        outs = []
        for mode in modes:
            ctx = JRiccatiOps(jn, pallas_mode="never").prepare(Z, lam, nu, stagewise=mode)
            dZ, lam_p, ok, delta, _ = ctx.kkt_step(Sig, D, g_hat, rhs_c, jnp.asarray(0.0), opt)
            outs.append((dZ, lam_p, ctx.Ji(dZ), ok, delta))
        return outs, ctx.JeT(lam), ctx.JiT(vin), ctx.Ji(g_hat)

    routs, jJeT, jJiT, jJi = ref(*map(jnp.asarray, (Z, lam, nu, Sig, D, g_hat, rhs_c, vin)))
    ops = TRiccatiOps(tn)
    topt = TIPMOptions().astype(torch.float64)
    c_i = np.asarray(jn.c_in(jnp.asarray(Z)))
    for mode, (jdZ, jlam, jJidZ, jok, jdelta) in zip(modes, routs):
        ctx = ops.prepare(_t(Z), _t(lam), _t(nu), stagewise=mode)
        dZ, lam_p, ok, delta, _ = ctx.kkt_step(_t(Sig), _t(D), _t(g_hat), _t(rhs_c),
                                               torch.zeros(1, dtype=torch.float64), topt)
        _close(jdZ, dZ[0], 1e-10)
        _close(jlam, lam_p[0], 1e-10)
        # ν⁺ = μ/s − D·ds with ds = −(c_i + s) − J_i dZ (μ = 0.1)
        jnu = 0.1 / s - D * (-(c_i + s) - np.asarray(jJidZ))
        _close(jnu, 0.1 / s - D * (-(c_i + s) - ctx.Ji(dZ)[0].numpy()), 1e-10)
        assert bool(jok) == bool(ok[0])
        assert float(jdelta) == pytest.approx(float(delta[0]), rel=1e-12)
    _close(jJeT, ctx.JeT(_t(lam))[0], 1e-12)
    _close(jJiT, ctx.JiT(_t(vin))[0], 1e-12)
    _close(jJi, ctx.Ji(_t(g_hat))[0], 1e-12)


# ---------------- rollouts and slack removal -------------------------------- #


def test_rollouts_match():
    jt, integ = feasible_bilinear_traj(N=12)
    jp = dtx.DirectTrajOptProblem.create(jt, dtx.QuadraticRegularizer.create("u", jt, 1.0), integ)
    tp = from_numpy_problem(jp, "cpu")
    u = np.asarray(jt.data["u"])
    jx = dtx.bilinear_rollout(integ, jnp.array([1.0, 0.0]), jnp.asarray(u), 0.15)
    tx = tdx.bilinear_rollout(tp.integrators[0], torch.tensor([[1.0, 0.0]], dtype=torch.float64),
                              torch.as_tensor(u)[None], 0.15)
    _close(jx, tx[0], 1e-12)
    _close(dtx.rollout(integ, jt), tdx.rollout(tp.integrators[0], tp.trajectory)[0], 1e-12)
    goal = np.asarray(jt.final["x"])
    assert float(dtx.rollout_fidelity(integ, jt, goal)) == pytest.approx(
        float(tdx.rollout_fidelity(tp.integrators[0], tp.trajectory, _t(goal))[0]), rel=1e-12)


def test_remove_slack_variables(pairs):
    jp, tp, _, _ = pairs["l1_slack"]
    jr, tr = dtx.remove_slack_variables(jp), tdx.remove_slack_variables(tp)
    assert tr.trajectory.names == jr.trajectory.names == ("x", "u", "du")
    assert [type(c).__name__ for c in tr.constraints] == [type(c).__name__ for c in jr.constraints]
    assert tdx.remove_slack_variables(tr) is tr
