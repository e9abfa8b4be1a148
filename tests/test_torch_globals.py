"""Global variables in the port against the JAX package, at small sizes.

The global block g of ``Z = [z_1; …; z_N; g]``: the global objectives and
constraints (value, gradient and Jacobian at 1e-12, f64), the Riccati
backend's arrowhead border (the static structure bit for bit, one KKT step
at 1e-10), end-to-end solves (per-lane iteration counts equal, Z to 1e-8),
path 3's builder and its float32 outcome, K3 / K4 on a knot matrix that is
a view of Z with its global tail, and K1 at path 3's shape. Problems are
built in the JAX package (``tests/torch_twins.py``) and carried across by
``bridge.from_numpy_problem``; perturbations are drawn with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

import directtrajopt_tpu as dtx
import directtrajopt_tpu_torch as tdx
from directtrajopt_tpu.ops import riccati_kernel as rk
from directtrajopt_tpu.solvers.canonical import make_nlp as j_make_nlp
from directtrajopt_tpu.solvers.ops_riccati import RiccatiOps as JRiccatiOps
from directtrajopt_tpu.solvers.ops_riccati import analyze as j_analyze
from directtrajopt_tpu.solvers.options import IPMOptions as JIPMOptions
from directtrajopt_tpu.solvers.solve import solve_batch_compact as j_compact
from directtrajopt_tpu_torch import benchmarks as tbench
from directtrajopt_tpu_torch.bridge import from_numpy_problem
from directtrajopt_tpu_torch.ops import riccati_kernel as trk
from directtrajopt_tpu_torch.precision import check_device
from directtrajopt_tpu_torch.solvers.canonical import make_nlp as t_make_nlp
from directtrajopt_tpu_torch.solvers.ops_riccati import RiccatiOps as TRiccatiOps
from directtrajopt_tpu_torch.solvers.ops_riccati import analyze as t_analyze
from directtrajopt_tpu_torch.solvers.options import IPMOptions as TIPMOptions
from directtrajopt_tpu_torch.solvers.solve import cast_problem
from torch_twins import feasible_bilinear_traj, global_phase, riccati_globals

torch.set_num_threads(1)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1.0) if a.size else 0.0
    assert err < tol, err


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))[None]


# ---------------- objectives and constraints --------------------------------- #


def _traj():
    """A 9-knot trajectory (x 2, u 1) with a 3-wide global θ, bounded."""
    jt, _ = feasible_bilinear_traj(N=9)
    return dtx.Trajectory.create(
        dict(jt.data), timestep=0.15, controls="u", initial={"x": jt.initial["x"]},
        bounds={"theta": (-2.0, 2.0)}, global_data={"theta": [0.3, -0.4, 0.7]})


_OBJECTIVES = {
    "null": lambda jt: (dtx.NullObjective(), None),
    "global": lambda jt: (
        dtx.GlobalObjective.create(lambda th: jnp.sum(th**2) + jnp.prod(th), "theta", jt, Q=2.0),
        lambda th: (th**2).sum() + th.prod()),
    "global_knot": lambda jt: (
        dtx.GlobalKnotPointObjective.create(lambda v: jnp.sum(v**2) * v[-1], ["x", "u"],
                                            "theta", jt, times=[2, 5], Qs=[0.5, 1.5]),
        lambda v: (v**2).sum() * v[-1]),
    "global_knot_params": lambda jt: (
        dtx.GlobalKnotPointObjective.create(lambda v, p: p[0] * jnp.sum((v - p[1]) ** 2), "x",
                                            "theta", jt, [np.array([0.2, 0.1 * t])
                                                          for t in range(9)]),
        lambda v, p: p[0] * ((v - p[1]) ** 2).sum()),
    "global_terminal": lambda jt: (
        dtx.GlobalTerminalObjective(lambda v: jnp.sin(v[0]) * v[-2], "x", "theta", jt, Q=3.0),
        lambda v: torch.sin(v[0]) * v[-2]),
}


@pytest.mark.parametrize("kind", list(_OBJECTIVES))
def test_global_objectives_match(kind):
    """Value and gradient (over Z, global block included) of each global
    objective, beside a quadratic regularizer, against the JAX package."""
    jt = _traj()
    jo, fn = _OBJECTIVES[kind](jt)
    jp = dtx.DirectTrajOptProblem.create(jt, dtx.QuadraticRegularizer.create("u", jt, 1.0) + jo,
                                         [])
    tp = from_numpy_problem(jp, "cpu", functions={} if fn is None else {("objective", 1): fn})
    Z = np.asarray(jt.to_zvec()) + 0.1 * np.random.default_rng(1).standard_normal(jt.layout.z_dim)
    jtr, ttr = jt.from_zvec(jnp.asarray(Z)), tp.trajectory.from_zvec(_t(Z))
    for j_obj, t_obj in ((jp.objective, tp.objective),
                         (jp.objective.objectives[1], tp.objective.objectives[1])):
        _close(dtx.objective_value(j_obj, jtr), tdx.objective_value(t_obj, ttr)[0], 1e-12)
        _close(dtx.objectives.objective_gradient(j_obj, jtr),
               tdx.objectives.objective_gradient(t_obj, ttr)[0], 1e-12)
    assert tp.objective.uses_global == jp.objective.uses_global


def _constraint_problem(kind):
    jt = _traj()
    fns = {}
    if kind == "global_linear":
        con = dtx.GlobalLinearConstraint.create(
            "theta", np.array([[1.0, -1.0, 0.0], [0.0, 1.0, 1.0], [2.0, 0.0, 1.0]]),
            lb=[0.1, -1.0, -np.inf], ub=[0.1, 2.0, 1.5])
    elif kind == "fix_global":
        jt, con = dtx.fix_global_variable(jt, "theta", [0.1, 0.2, 0.3])
    elif kind == "global_equality_scalar":
        con = dtx.GlobalEqualityConstraint.create("theta", 0.25)
    elif kind in ("nonlinear_global", "nonlinear_global_ineq"):
        con = dtx.NonlinearGlobalConstraint.create(
            lambda th: jnp.array([jnp.sum(th**2) - 1.0, th[0] * th[2]]), "theta", jt,
            equality=kind == "nonlinear_global")
        fns[("constraint", 0)] = lambda th: torch.stack([(th**2).sum() - 1.0, th[0] * th[2]])
    else:
        con = dtx.NonlinearGlobalKnotPointConstraint.create(
            lambda v, p: jnp.array([v[0] * v[-1] - p[0], jnp.sum(v) - p[1]]), ["x", "u"],
            "theta", jt, [np.array([0.1, 0.2]), np.array([0.3, -0.1])], times=[2, 6],
            equality=kind == "nonlinear_global_knot")
        fns[("constraint", 0)] = lambda v, p: torch.stack([v[0] * v[-1] - p[0], v.sum() - p[1]])
    jp = dtx.DirectTrajOptProblem.create(jt, dtx.QuadraticRegularizer.create("u", jt, 1.0), [],
                                         constraints=[con])
    return jp, from_numpy_problem(jp, "cpu", functions=fns)


@pytest.mark.parametrize("kind", [
    "global_linear", "fix_global", "global_equality_scalar", "nonlinear_global",
    "nonlinear_global_ineq", "nonlinear_global_knot", "nonlinear_global_knot_ineq",
])
def test_global_constraints_match(kind):
    """Pins, bounds (the trajectory's global bounds included), linear rows,
    and the residuals and Jacobians of c_eq / c_in at a random Z."""
    jp, tp = _constraint_problem(kind)
    jn, tn = j_make_nlp(jp), t_make_nlp(tp)
    assert np.array_equal(jn.fix_idx, tn.fix_idx) and jn.z_dim == tn.z_dim
    _close(jn.fix_val, tn.fix_val[0], 0.0 + 1e-15)
    for a, b in ((jn.lb, tn.lb[0]), (jn.ub, tn.ub[0])):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert (jn.n_lin_eq, jn.n_lin_in, jn.n_eq, jn.n_in) == (tn.n_lin_eq, tn.n_lin_in, tn.n_eq,
                                                            tn.n_in)
    Z = np.asarray(jp.trajectory.to_zvec()) + 1e-1 * np.random.default_rng(0).standard_normal(
        jn.z_dim)

    @jax.jit
    def ref(Z):
        return jn.c_eq(Z), jn.c_in(Z), jax.jacfwd(jn.c_eq)(Z), jax.jacfwd(jn.c_in)(Z)

    jce, jci, jJe, jJi = ref(jnp.asarray(Z))
    Zt = _t(Z)
    _close(jce, tn.c_eq(Zt)[0], 1e-12)
    _close(jci, tn.c_in(Zt)[0], 1e-12)
    _close(jJe, jacfwd(lambda z: tn.c_eq(z[None])[0])(Zt[0]), 1e-12)
    _close(jJi, jacfwd(lambda z: tn.c_in(z[None])[0])(Zt[0]), 1e-12)
    # the trial-grid form: extra axes broadcast against the lane's data
    Z3 = torch.stack([Zt, 2 * Zt], dim=1)
    assert torch.equal(tn.c_eq(Z3)[:, 1], tn.c_eq(2 * Zt))


def test_global_constraint_constructors():
    """The port's own constructors: g_dim probes, the infeasible all-zero
    row, and per-lane values from host data."""
    jt = _traj()
    tt = from_numpy_problem(dtx.DirectTrajOptProblem.create(
        jt, dtx.QuadraticRegularizer.create("u", jt, 1.0), []), "cpu").trajectory
    c = tdx.NonlinearGlobalConstraint.create(lambda th: th[:2] * 2.0, "theta", tt)
    assert c.g_dim == 2 and not hasattr(c, "knot_residual")
    k = tdx.NonlinearGlobalKnotPointConstraint.create(lambda v: v[:3], "x", "theta", tt,
                                                      times=[1, 4])
    assert (k.g_dim, k.times, k.uses_global) == (3, (1, 4), True)
    with pytest.raises(ValueError, match="infeasible"):
        tdx.GlobalLinearConstraint.create("theta", np.zeros((1, 3)), lb=[1.0], traj=tt)
    b = tdx.GlobalBoundsConstraint.create("theta", 1.5, tt)
    assert b.lb.shape == (1, 3) and float(b.ub[0, 2]) == 1.5
    tt2, pin = tdx.fix_global_variable(tt, "theta", [1.0, 2.0, 3.0])
    assert "theta" not in tt2.bounds and pin.values.tolist() == [[1.0, 2.0, 3.0]]
    assert tdx.traj_slice(2, 3) == slice(6, 9) and tdx.traj_index(2, 1, 3) == 7
    assert tt.layout.global_z_slice("theta") == slice(27, 30)


def test_per_lane_global_linear_constructor():
    """``GlobalLinearConstraint.create`` takes a (B, rows, g) tensor as a
    per-lane A (on the trajectory's dtype and device), refuses one of
    another lane count, and checks every lane's all-zero rows."""
    jt = _traj()
    tt = from_numpy_problem(dtx.DirectTrajOptProblem.create(
        jt, dtx.QuadraticRegularizer.create("u", jt, 1.0), []), "cpu").trajectory
    A = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3)
    c = tdx.GlobalLinearConstraint.create("theta", A, lb=[0.0, -1.0], ub=[0.0, 1.0], traj=tt)
    assert c.A.shape == (1, 2, 3) and c.A.dtype == tt.data["x"].dtype
    assert c.eq_mask == (True, False)
    with pytest.raises(ValueError, match="lanes"):
        tdx.GlobalLinearConstraint.create("theta", torch.ones(2, 1, 3), lb=[0.0], traj=tt)
    with pytest.raises(ValueError, match="infeasible"):
        tdx.GlobalLinearConstraint.create("theta", torch.zeros(1, 1, 3), lb=[1.0], traj=tt)


# ---------------- the arrowhead border --------------------------------------- #


@pytest.fixture(scope="module")
def arrowhead():
    """with_border_ineq -> (JAX problem, port problem, JAX NLP, port NLP)."""
    out = {}
    for bi in (False, True):
        jp, fns = riccati_globals(bi)
        tp = from_numpy_problem(jp, "cpu", functions=fns)
        out[bi] = (jp, tp, j_make_nlp(jp), t_make_nlp(tp))
    return out


@pytest.mark.parametrize("border_ineq", [False, True])
def test_analyze_globals_bit_equal(arrowhead, border_ineq):
    _, _, jn, tn = arrowhead[border_ineq]
    js, ts = j_analyze(jn), t_analyze(tn)
    assert ts.n_g == js.n_g == 2
    for f in ("s_idx", "v_idx", "core_mask", "g_free", "lin_border_rows", "bp_steps", "bp_flat",
              "in_knot", "in_slot", "m_in", "ib_flat", "ib_lin_rows", "in_fast_mask",
              "lin_nnz_keep", "nl_eq_offsets", "nl_in_offsets"):
        assert np.array_equal(np.asarray(getattr(js, f)), np.asarray(getattr(ts, f))), f


@pytest.mark.parametrize("border_ineq", [False, True])
def test_kkt_step_globals_matches(arrowhead, border_ineq):
    """One arrowhead KKT step (exact and Gauss-Newton Hessian), its fused
    two-rhs resolve, the arrowhead Hessian blocks and the matvecs, at a
    random iterate."""
    jp, tp, jn, tn = arrowhead[border_ineq]
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
        for gn in (False, True):
            ctx = JRiccatiOps(jn, pallas_mode="never").prepare(Z, lam, nu, gauss_newton=gn)
            dZ, lam_p, ok, delta, res = ctx.kkt_step(Sig, D, g_hat, rhs_c, jnp.asarray(0.0), opt)
            dZ2, lam2 = res.many(jnp.stack([-g_hat, g_hat]), jnp.stack([rhs_c, -rhs_c]))
            outs.append((dZ, lam_p, ok, delta, dZ2, lam2, ctx.Hzg, ctx.Hgg))
        return outs, ctx.JeT(lam), ctx.JiT(vin), ctx.Ji(g_hat), ctx.grad_f

    routs, jJeT, jJiT, jJi, jgf = ref(*map(jnp.asarray, (Z, lam, nu, Sig, D, g_hat, rhs_c, vin)))
    topt = TIPMOptions().astype(torch.float64)
    for gn, (jdZ, jlam, jok, jdelta, jdZ2, jlam2, jHzg, jHgg) in zip((False, True), routs):
        ctx = TRiccatiOps(tn).prepare(_t(Z), _t(lam), _t(nu), gauss_newton=gn)
        _close(jHzg, ctx.Hzg[0], 1e-12)
        _close(jHgg, ctx.Hgg[0], 1e-12)
        dZ, lam_p, ok, delta, res = ctx.kkt_step(_t(Sig), _t(D), _t(g_hat), _t(rhs_c),
                                                 torch.zeros(1, dtype=torch.float64), topt)
        _close(jdZ, dZ[0], 1e-10)
        _close(jlam, lam_p[0], 1e-10)
        assert bool(jok) == bool(ok[0])
        assert float(jdelta) == pytest.approx(float(delta[0]), rel=1e-12)
        dZ2, lam2 = res.many(torch.stack([_t(-g_hat), _t(g_hat)], dim=1),
                             torch.stack([_t(rhs_c), _t(-rhs_c)], dim=1))
        _close(jdZ2, dZ2[0], 1e-10)
        _close(jlam2, lam2[0], 1e-10)
    _close(jgf, ctx.grad_f[0], 1e-12)
    _close(jJeT, ctx.JeT(_t(lam))[0], 1e-12)
    _close(jJiT, ctx.JiT(_t(vin))[0], 1e-12)
    _close(jJi, ctx.Ji(_t(g_hat))[0], 1e-12)


def test_global_block_certified_inside_the_retry():
    """The reduced global Hessian's Cholesky is part of the δ_w certificate:
    with a strongly negative curvature along the global direction that no
    constraint fixes (θ ∝ (1, −1) in the global-phase problem), the first
    factorization fails and the ladder raises δ_w until the certificate
    holds; the step then solves the regularized system."""
    jp, fns = global_phase(1, 12)
    tp = from_numpy_problem(jp, "cpu", functions=fns)
    tn = t_make_nlp(tp)
    rng = np.random.default_rng(4)
    free = tn.free_mask.numpy()
    Sig = np.abs(rng.standard_normal(tn.z_dim)) * free
    Sig[-2:] = 0.0
    g_hat = rng.standard_normal(tn.z_dim) * free
    rhs_c = rng.standard_normal(tn.n_eq)
    topt = TIPMOptions().astype(torch.float64)
    zeros = dict(dtype=torch.float64)
    ctx = TRiccatiOps(tn).prepare(tp.trajectory.to_zvec(), torch.zeros((1, tn.n_eq), **zeros),
                                  torch.zeros((1, tn.n_in), **zeros))
    step = dict(Sig=_t(Sig), D=torch.ones((1, tn.n_in), dtype=torch.float64), g_hat=_t(g_hat),
                rhs_c=_t(rhs_c), delta_last=torch.zeros(1, dtype=torch.float64), opt=topt)
    _, _, ok, delta, _ = ctx.kkt_step(**step)
    assert bool(ok[0]) and float(delta[0]) == 0.0
    ctx.Hgg = ctx.Hgg - 50.0 * torch.eye(2, dtype=torch.float64)
    dZ, _, ok, delta, _ = ctx.kkt_step(**step)
    assert bool(ok[0]) and float(delta[0]) > 1.0 and torch.isfinite(dZ).all()


# ---------------- end to end ------------------------------------------------- #


@pytest.mark.parametrize("hessian", ["exact", "gauss_newton"])
def test_global_phase_solve_matches_jax(hessian):
    """The arrowhead end-to-end fixture at N=12, three lanes, f64, tol 1e-9:
    per-lane iteration counts equal and Z within 1e-8 of the JAX package's."""
    jp, fns = global_phase(3, 12)
    kw = dict(max_iter=200, tol=1e-9, hessian_approximation=hessian)
    jr = dtx.solve_batch(jp, **kw)
    tr = tdx.solve(from_numpy_problem(jp, "cpu", functions=fns), **kw)
    assert np.array_equal(np.asarray(jr.iterations), tr.iterations.numpy())
    assert tr.converged.all() and np.asarray(jr.converged).all()
    Zj = np.asarray(jr.problem.trajectory.to_zvec())
    assert np.max(np.abs(Zj - tr.problem.trajectory.to_zvec().numpy())) < 1e-8
    th = tr.problem.trajectory.global_data["theta"].numpy()
    assert np.max(np.abs(th.sum(1) - 0.2)) < 1e-9


def test_per_lane_global_linear_a_matches_jax():
    """A per-lane ``GlobalLinearConstraint.A`` (lane ℓ: θ[0] + (1 + 0.25ℓ)·θ[1]
    = 0.2) on four lanes of path 3's family at N=12, f64, tol 1e-9: the
    bridge carries A as a (B, rows, g) tensor, the canon's values are per
    lane, and the solve takes the JAX package's iterations lane for lane to
    its Z (1e-8), each lane on its own row."""
    A = [np.array([[1.0, 1.0 + 0.25 * lane]]) for lane in range(4)]
    jp, fns = global_phase(4, 12, A_lanes=A)
    tp = from_numpy_problem(jp, "cpu", functions=fns)
    con = next(c for c in tp.constraints if isinstance(c, tdx.GlobalLinearConstraint))
    assert isinstance(con.A, torch.Tensor) and tuple(con.A.shape) == (4, 1, 2)
    nlp = t_make_nlp(tp)
    assert nlp.A_eq.vals.shape[0] == 4 and not torch.equal(nlp.A_eq.vals[0], nlp.A_eq.vals[1])
    kw = dict(max_iter=200, tol=1e-9)
    jr = dtx.solve_batch(jp, **kw)
    tr = tdx.solve(tp, **kw)
    assert np.array_equal(np.asarray(jr.iterations), tr.iterations.numpy())
    assert tr.converged.all() and np.asarray(jr.converged).all()
    Zj = np.asarray(jr.problem.trajectory.to_zvec())
    assert np.max(np.abs(Zj - tr.problem.trajectory.to_zvec().numpy())) < 1e-8
    th = tr.problem.trajectory.global_data["theta"].numpy()
    assert np.max(np.abs((th * np.concatenate(A)).sum(1) - 0.2)) < 1e-9


def test_fix_global_variable_solves():
    """θ pinned by ``fix_global_variable``: its coordinates leave the
    arrowhead (g_free = 0), keep their values, and the solve takes the JAX
    package's iterations to its Z (1e-8)."""
    jp, fns = global_phase(1, 12, fix_theta=(0.1, 0.1))
    tp = from_numpy_problem(jp, "cpu", functions=fns)
    assert t_analyze(t_make_nlp(tp)).g_free.tolist() == [0.0, 0.0]
    kw = dict(max_iter=200, tol=1e-9)
    jr = dtx.solve(jp, **kw)  # one lane: an unbatched problem
    tr = tdx.solve(tp, **kw)
    assert tr.converged.all() and bool(jr.converged)
    assert int(jr.iterations) == int(tr.iterations[0])
    Zj = np.asarray(jr.problem.trajectory.to_zvec())
    assert np.max(np.abs(Zj - tr.problem.trajectory.to_zvec().numpy())) < 1e-8
    assert tr.problem.trajectory.global_data["theta"].tolist() == [[0.1, 0.1]]
    u = tr.problem.trajectory.data["u"][0, 3, 0].item()
    assert abs(u - 0.5 * 0.1 - 0.1) < 1e-9


def test_global_builder_matches_twin_and_golden():
    """Path 3's builder poses the JAX twin's problems (lane ℓ from seed ℓ),
    its lane 0 is the golden's problem, and its analysis gives K1's grouped
    shape (2, 1, 7)."""
    jp, _ = global_phase(2, 51)
    tp = tbench.make_batched_global_problems(2, N=51, device="cpu")
    np.testing.assert_allclose(tp.trajectory.to_zvec().numpy(),
                               np.asarray(jp.trajectory.to_zvec()), rtol=0, atol=1e-12)
    g = np.load(tbench.GOLDEN_GLOBAL_PHASE)
    np.testing.assert_allclose(tp.trajectory.to_zvec()[0].numpy(), g["Z0"], rtol=0, atol=1e-12)
    assert int(g["N"]) == 51 and int(g["status"]) == 0
    assert "make_global_phase.py" in str(g["command"])
    nlp = t_make_nlp(tp)
    S = t_analyze(nlp)
    m_c = len(S.bp_steps) + len(S.lin_border_rows) + nlp.n_nl_eq + len(S.ib_flat)
    shape = (len(S.s_idx), len(S.v_idx), m_c + S.n_g + 1)
    assert shape == (2, 1, 7) and shape in trk.GROUPED_SHAPES


def test_global_phase_f32_matches_jax():
    """Path 3's configuration at 8 lanes, f32 on the CPU: the per-lane
    outcome equals the JAX package's, at ``global_config``'s δ_c = 1e-7 (every
    lane certified) and at the default 1e-8, where both packages fail every
    lane (status 5)."""
    B = 8
    cfg = tbench.global_config()
    jp, _ = global_phase(B, 51)
    tp = cast_problem(tbench.make_batched_global_problems(B, N=51, device="cpu"), torch.float32)
    j32 = dtx.cast_problem(jp, jnp.float32)
    for delta_c in (1e-7, 1e-8):
        kw = dict(cfg["solve_kw"], chunk=B, delta_c=delta_c)
        jr, tr = j_compact(j32, **kw), tdx.solve_batch_compact(tp, **kw)
        assert np.array_equal(np.asarray(jr.iterations), tr.iterations.numpy())
        assert np.array_equal(np.asarray(jr.status), tr.status.numpy())
        assert np.array_equal(np.asarray(jr.converged), tr.converged.numpy())
        if delta_c == cfg["solve_kw"]["delta_c"]:
            assert tr.converged.all() and float(tr.kkt_error.max()) <= 1e-6
            err_u, err_th, lin, eq3, err_ref = tbench.global_certificate(tr)
            assert len(err_ref) == B and err_ref.max() <= 1e-4
            assert err_u.max() <= 1e-2 and err_th.max() <= 1e-4
            assert lin.max() <= 1e-6 and eq3.max() <= 1e-6
        else:
            assert tr.status.tolist() == [5] * B


# ---------------- kernels on the tailed knot matrix -------------------------- #


def test_window_kernels_read_the_tailed_knot_matrix_in_place():
    """K3 and K4 take the knot matrix as a view of Z = [z_1; …; z_N; θ]
    (lane stride N·d + n_g, 155 floats here): their arguments share Z's
    storage, and the results equal those on a contiguous copy."""
    tp = cast_problem(tbench.make_batched_global_problems(3, N=51, device="cpu"), torch.float32)
    integ, lay = tp.integrators[0], tp.trajectory.layout
    N, d = lay.N, lay.dim
    Z = tp.trajectory.to_zvec()
    assert Z.shape[1] == N * d + 2 == 155
    zmat = t_make_nlp(tp)._zmat(Z)
    assert zmat.data_ptr() == Z.data_ptr() and zmat.stride()[:2] == (155, d)
    dZ = torch.as_tensor(1e-3 * np.random.default_rng(0).standard_normal((3, 4, 155)),
                         dtype=torch.float32)
    Zt = Z[:, None] + dZ
    zt = t_make_nlp(tp)._zmat(Zt)
    views = integ._trial_views(lay, zt)
    for v in (zt, views[2], views[4], views[5]):  # u, x, x_next (Δt is a fixed scalar)
        assert v.untyped_storage().data_ptr() == Zt.untyped_storage().data_ptr()
    for fn in (integ.jacobians_zk_stacked, integ.residuals_stacked):
        assert torch.equal(fn(lay, zmat), fn(lay, zmat.contiguous()))
    assert torch.equal(integ.residuals_stacked(lay, zt),
                       integ.residuals_stacked(lay, zt.contiguous()))
    assert torch.equal(integ.residuals_l1_stacked(lay, zt),
                       integ.residuals_l1_stacked(lay, zt.contiguous()))


def test_path3_k1_shape_f32_matches_pallas_interpret():
    """K1 at path 3's shape, (n_s, n_v, R) = (2, 1, 7), N=51, the initial
    state pinned, lane 2 indefinite, against the JAX package's Pallas kernel
    in interpret mode: 5e-6 relative on the certified lanes, ``ok`` equal."""
    ns, nv, R, N = 2, 1, 7, 51
    rng = np.random.default_rng(11)
    B = 4

    def sym(x):
        return 0.5 * (x + np.swapaxes(x, -1, -2))

    Qss = sym(rng.standard_normal((B, N, ns, ns))) * 0.1 + 2.0 * np.eye(ns)
    Qsv = rng.standard_normal((B, N, ns, nv)) * 0.1
    Qvv = sym(rng.standard_normal((B, N, nv, nv))) * 0.1 + 2.0 * np.eye(nv)
    A = rng.standard_normal((B, N, ns, ns)) * 0.3
    Bm = rng.standard_normal((B, N, ns, nv)) * 0.3
    A[:, -1] = Bm[:, -1] = 0.0
    qs, qv, b = (rng.standard_normal((B, R, N, n)) for n in (ns, nv, ns))
    b[:, :, -1] = 0.0
    args = [a.astype(np.float32) for a in (Qss, Qsv, Qvv, A, Bm, qs, qv, b)]
    args[2][2, 30] = -1e6
    s0m = np.zeros(ns)
    ref = rk._factor_solve_pallas(s0m, *map(jnp.asarray, args), interpret=True)
    out = trk.factor_solve(s0m, *(torch.as_tensor(a) for a in args))
    ok = np.asarray(ref[5])
    assert (ok == out[5].numpy()).all() and ok.tolist() == [True, True, False, True]
    for i, (x, y) in enumerate(zip(ref, out)):
        if i != 5:
            x, y = np.asarray(x)[ok], y.numpy()[ok]
            assert np.max(np.abs(x - y)) / max(np.max(np.abs(x)), 1.0) < 5e-6, i


# ---------------- the device policy ------------------------------------------ #


def test_device_none_means_the_card():
    """``device=None`` (the builders' default) is the card: without one it
    raises, and nothing falls back to the CPU."""
    assert check_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert check_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.make_batched_global_problems(2, N=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdx.BilinearIntegrator.create((np.eye(2), [np.eye(2)]), "x", "u", batch=1)
