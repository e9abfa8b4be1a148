"""The constrained test problems, built in the JAX package, with the torch
counterparts of their user functions for ``bridge.from_numpy_problem``.

Each builder returns ``(jax_problem, functions)``. The problems are those of
``tests/test_solve.py`` (92-241) and ``tests/test_promotion.py`` with the
bilinear integrator's Taylor method (the port's default and the kernels'),
plus two that exercise what those leave out: a duration
range whose lower bound is active (a border inequality) and a problem with a
nonlinear equality, a multi-variable nonlinear inequality with per-time
parameters, and terminal and parametrized knot objectives. The global
problems are the JAX package's arrowhead fixtures: ``make_problem(with_globals=True)``
of ``tests/test_riccati.py`` (with and without border inequalities) and its
end-to-end global-phase problem (``tests/test_riccati.py:434``, the same as
``tests/test_gauss_newton.py:44``), one lane per start. ``E2E`` holds the
end-to-end fixtures of ``tests/test_riccati.py`` (``:357``, ``:407``,
``:434``) as they are, on the Padé method, each returning ``(problem,
functions, solve kwargs)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.linalg import expm

import directtrajopt_tpu as dtx

G_DRIFT = np.array([[0.0, 1.0], [-1.0, 0.0]])
G_DRIVE = np.array([[0.0, 1.0], [1.0, 0.0]])


def rollout(x0, u, dt):
    """Host rollout x_{k+1} = exp(Δt (G_d + u_k G_u)) x_k of the 2-D transfer
    (the JAX package's ``bilinear_rollout``, without a compile per length)."""
    xs = [np.asarray(x0, dtype=float)]
    for uk in np.asarray(u)[:-1, 0]:
        xs.append(expm(dt * (G_DRIFT + uk * G_DRIVE)) @ xs[-1])
    return np.stack(xs)


def bilinear_integrator():
    return dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", None, method="taylor")


def feasible_bilinear_traj(N=20, dt=0.15, seed=0, u_scale=0.3):
    """``tests/test_solve.py::feasible_bilinear_traj`` with the Taylor integrator."""
    rng = np.random.default_rng(seed)
    u = u_scale * np.sin(np.linspace(0, 2 * np.pi, N))[:, None]
    integ = bilinear_integrator()
    x0 = np.array([1.0, 0.0])
    xs = rollout(x0, u, dt)
    traj = dtx.Trajectory.create(
        {"x": xs + 0.05 * rng.normal(size=(N, 2)), "u": u + 0.05 * rng.normal(size=(N, 1))},
        timestep=dt, controls="u", initial={"x": x0}, final={"x": xs[-1]},
    )
    return traj, integ


def state_constrained(B=1, N=20, cap=None):
    """``test_nonlinear_inequality_e2e``: ‖x_k‖² ≤ cap, one lane per seed
    (lane ℓ from seed ℓ), the cap from lane 0's guess (its max ‖x_k‖² plus
    0.2) unless given. Batched when B > 1."""
    lanes = [feasible_bilinear_traj(N=N, seed=lane) for lane in range(B)]
    if cap is None:
        cap = float(np.max(np.sum(np.asarray(lanes[0][0].data["x"]) ** 2, axis=1))) + 0.2

    def g(x):
        return jnp.array([jnp.sum(x**2) - cap])

    probs = []
    for traj, integ in lanes:
        con = dtx.NonlinearKnotPointConstraint.create(g, "x", traj, equality=False)
        probs.append(dtx.DirectTrajOptProblem.create(
            traj, dtx.QuadraticRegularizer.create("u", traj, 1.0), integ, constraints=[con]))
    prob = jax.tree.map(lambda *xs: jnp.stack(xs), *probs) if B > 1 else probs[0]
    return prob, {("constraint", 0): lambda x: (x * x).sum(-1, keepdim=True) - cap}


def _free_time(N, bounds, seed=0, dt_data=None):
    traj, integ = feasible_bilinear_traj(N=N, seed=seed)
    data = dict(traj.data)
    data["dt"] = np.full((N, 1), 0.15) if dt_data is None else dt_data
    traj = dtx.Trajectory.create(data, timestep="dt", controls="u",
                                 initial={"x": traj.initial["x"]},
                                 final={"x": traj.final["x"]}, bounds=bounds)
    return traj, integ


def minimum_time():
    """``test_free_time_minimum_time``."""
    traj, integ = _free_time(16, {"dt": (0.03, 0.3), "u": 1.0})
    obj = dtx.QuadraticRegularizer.create("u", traj, 1e-1) \
        + 2.0 * dtx.MinimumTimeObjective.create(traj, 1.0)
    return dtx.DirectTrajOptProblem.create(traj, obj, integ), {}


def duration():
    """``test_duration_constraint``: Σ Δt = 0.15·(N−1)."""
    traj, integ = _free_time(16, {"dt": (0.05, 0.4)})
    return dtx.DirectTrajOptProblem.create(
        traj, dtx.QuadraticRegularizer.create("u", traj, 1.0), integ,
        constraints=[dtx.DurationConstraint(0.15 * 15)]), {}


def duration_range():
    """A duration range whose lower bound the minimum-time term makes active."""
    traj, integ = _free_time(16, {"dt": (0.05, 0.4)})
    target = 0.15 * 15
    obj = dtx.QuadraticRegularizer.create("u", traj, 1.0) \
        + 0.5 * dtx.MinimumTimeObjective.create(traj, 1.0)
    return dtx.DirectTrajOptProblem.create(
        traj, obj, integ,
        constraints=[dtx.DurationConstraint(lb=target - 0.2, ub=target + 0.1)]), {}


def timesteps_all_equal():
    """``test_timesteps_all_equal``."""
    rng = np.random.default_rng(5)
    traj, integ = _free_time(12, {"dt": (0.05, 0.4)}, dt_data=0.15 + 0.02 * rng.random((12, 1)))
    return dtx.DirectTrajOptProblem.create(
        traj, dtx.QuadraticRegularizer.create("u", traj, 1.0), integ,
        constraints=[dtx.TimeStepsAllEqualConstraint()]), {}


def symmetry():
    """``test_symmetry_constraint_e2e``."""
    N = 14
    traj = dtx.Trajectory.create({"x": np.zeros((N, 1)), "v": 0.1 * np.ones((N, 1))},
                                 timestep=0.1, controls="v", initial={"x": [0.0]},
                                 final={"x": [0.5]})
    return dtx.DirectTrajOptProblem.create(
        traj, dtx.QuadraticRegularizer.create("v", traj, 1.0),
        dtx.DerivativeIntegrator.create("x", "v", traj),
        constraints=[dtx.SymmetryConstraint.create("v", [0], even=True)]), {}


def l1_slack():
    """``test_l1_slack_sparsity``: |du| ≤ s with a linear penalty on s."""
    traj, integ = feasible_bilinear_traj(N=16)
    N = traj.N
    data = dict(traj.data)
    data["du"] = np.zeros((N, 1))
    data["s"] = 0.2 * np.ones((N, 1))
    traj = dtx.Trajectory.create(data, timestep=0.15, controls=("u", "du"),
                                 initial={"x": traj.initial["x"]},
                                 final={"x": traj.final["x"]}, bounds={"s": (0.0, np.inf)})
    obj = dtx.QuadraticRegularizer.create("u", traj, 1e-2) \
        + 1.0 * dtx.LinearRegularizer.create("s", traj, 1.0)
    return dtx.DirectTrajOptProblem.create(
        traj, obj, [integ, dtx.DerivativeIntegrator.create("u", "du", traj)],
        constraints=[dtx.L1SlackConstraint.create("du", "s", traj)]), {}


def promotion(N, with_t=True, all_equal=False, pin_t=False):
    """``tests/test_promotion.py::_free_time_problem`` (and, with ``pin_t``,
    the pinned-final-t problem of ``test_pinned_promoted_target_goes_to_border``)."""
    rng = np.random.default_rng(0)
    integ = bilinear_integrator()
    u = 0.3 * rng.standard_normal((N, 1))
    xs = rollout([1.0, 0.0], u, 0.1)
    data = {"x": xs, "u": u, "dt": np.full((N, 1), 0.1)}
    initial, final = {"x": [1.0, 0.0]}, {"x": xs[-1]}
    if with_t:
        data["t"] = (np.cumsum(np.full(N, 0.1)) - 0.1).reshape(N, 1)
        initial["t"] = [0.0]
        if pin_t:
            final["t"] = [float(data["t"][-1, 0])]
    traj = dtx.Trajectory.create(data, timestep="dt", controls=("u", "dt"), initial=initial,
                                 final=final, bounds={"dt": (0.01, 0.5), "u": 1.0})
    obj = dtx.QuadraticRegularizer.create("u", traj, 1.0)
    if with_t and not pin_t:
        obj = obj + dtx.MinimumTimeObjective.create(traj, 1.0)
    cons = [dtx.TimeStepsAllEqualConstraint()] if all_equal else []
    return dtx.DirectTrajOptProblem.create(traj, obj, [integ], constraints=cons), {}


def nonlinear_mixed():
    """A nonlinear equality ‖x_6‖² = 1, a two-row inequality in (x, u) with
    per-time parameters (separate-argument convention) at knots 3, 6, 9, a
    terminal objective and a parametrized knot objective."""
    traj, integ = feasible_bilinear_traj(N=12)
    goal = np.asarray(traj.final["x"])
    times = [3, 6, 9]
    ceq = dtx.NonlinearKnotPointConstraint.create(
        lambda x: jnp.array([x[0] ** 2 + x[1] ** 2 - 1.0]), "x", traj, times=[6])
    cin = dtx.NonlinearKnotPointConstraint.create(
        lambda x, u, p: jnp.array([x[0] * u[0] - p[0], u[0] ** 2 - p[1]]), ["x", "u"], traj,
        params=[np.array([0.5, 0.3 + 0.01 * t]) for t in times], equality=False, times=times)
    knots = list(range(0, 12, 2))
    obj = (dtx.QuadraticRegularizer.create("u", traj, 1.0)
           + dtx.TerminalObjective(lambda x: jnp.sum((x - goal) ** 2), "x", traj, Q=3.0)
           + dtx.KnotPointObjective.create(
               lambda z, p: p[0] * jnp.sum((z - p[1]) ** 2), ["x"], traj,
               params=[np.array([0.1, 0.2 * t]) for t in knots], times=knots))
    goal_t = torch.as_tensor(goal)
    return dtx.DirectTrajOptProblem.create(traj, obj, integ, constraints=[ceq, cin]), {
        ("constraint", 0): lambda x: torch.stack([x[0] ** 2 + x[1] ** 2 - 1.0]),
        ("constraint", 1): lambda x, u, p: torch.stack([x[0] * u[0] - p[0], u[0] ** 2 - p[1]]),
        ("objective", 1): lambda x: ((x - goal_t) ** 2).sum(),
        ("objective", 2): lambda z, p: p[0] * ((z - p[1]) ** 2).sum(),
    }


def _taylor(prob):
    """``prob`` with its bilinear integrators on the Taylor method."""
    return prob.replace(integrators=tuple(
        i.replace(method="taylor") if type(i).__name__ == "BilinearIntegrator" else i
        for i in prob.integrators))


def riccati_globals(with_border_ineq=False):
    """``tests/test_riccati.py::make_problem(with_globals=True)`` (every
    constraint of its zoo, a global objective, a global knot objective, a
    pure-global and a global-coupled nonlinear equality, a global linear
    row), with ``with_border_ineq`` its duration range, global-coupled and
    pure-global nonlinear inequalities and a global linear range."""
    from test_riccati import make_problem

    prob = _taylor(make_problem(with_globals=True, with_border_ineq=with_border_ineq))
    fns = {
        ("constraint", 1): lambda x: ((x**2).sum() - 2.5).reshape(1),
        ("constraint", 2): lambda u: (u[0] ** 3 - 0.001).reshape(1),
        ("constraint", 5): lambda th: ((th**2).sum() - 0.5).reshape(1),
        ("constraint", 6): lambda v: (v[0] + 0.2 * v[-1] ** 2 - 0.1).reshape(1),
        ("objective", 3): lambda th: (th**2).sum() + 0.1 * (th**4).sum(),
        ("objective", 4): lambda v: 0.05 * (v[0] * v[-1]) ** 2,
    }
    if with_border_ineq:
        fns[("constraint", 9)] = lambda v: (v[0] ** 2 + 0.3 * v[-1] - 1.2).reshape(1)
        fns[("constraint", 10)] = lambda th: ((th**2).sum() - 1.8).reshape(1)
    return prob, fns


def global_phase(B=1, N=12, seed0=0, fix_theta=None, A_lanes=None):
    """The global-phase family: the 2-D transfer with Δt = 0.12, |u| ≤ 0.8,
    x_1 = (1, 0) and x_N the final state of the rollout of
    u = 0.3·sin(linspace(0, 4, N)); a global θ ∈ ℝ² with |θ| ≤ 3; objective
    ½Σ‖Δt u_k‖² + Σ(θ − 0.3)² + Σ_k 0.02·(x_k[1] − θ[1])²; constraints
    u_3 − 0.5·θ[0] − 0.1 = 0 and θ[0] + θ[1] = 0.2. Lane ℓ starts from the
    rollout plus 0.02·N(0,1) on x and from θ = (0.4, −0.2) plus 0.2·N(0,1),
    both from ``np.random.default_rng(seed0 + ℓ)``. ``fix_theta``: pin θ
    there instead (``fix_global_variable``); ``A_lanes``: lane ℓ's row of the
    linear constraint A_lanes[ℓ]·θ = 0.2 (default (1, 1)). Batched when
    B > 1."""
    dt = 0.12
    u = 0.3 * np.sin(np.linspace(0, 4, N))[:, None]
    xs = rollout([1.0, 0.0], u, dt)

    def g_obj(th):
        return jnp.sum((th - 0.3) ** 2)

    def gk_obj(v):
        return 0.02 * (v[1] - v[-1]) ** 2

    def g_con(v):
        return jnp.array([v[0] - 0.5 * v[-2] - 0.1])

    probs = []
    for lane in range(B):
        rng = np.random.default_rng(seed0 + lane)
        x = xs + 0.02 * rng.normal(size=(N, 2))
        theta = np.array([0.4, -0.2]) + 0.2 * rng.normal(size=2)
        traj = dtx.Trajectory.create(
            {"x": x, "u": u}, timestep=dt, controls="u", initial={"x": [1.0, 0.0]},
            final={"x": xs[-1]}, bounds={"u": 0.8, "theta": 3.0}, global_data={"theta": theta})
        obj = (dtx.QuadraticRegularizer.create("u", traj, 1.0)
               + dtx.GlobalObjective.create(g_obj, "theta", traj)
               + dtx.GlobalKnotPointObjective.create(gk_obj, "x", "theta", traj))
        cons = [dtx.NonlinearGlobalKnotPointConstraint.create(g_con, "u", "theta", traj,
                                                              times=[3])]
        if fix_theta is None:
            A = np.array([[1.0, 1.0]]) if A_lanes is None else np.asarray(A_lanes[lane])
            cons.append(dtx.GlobalLinearConstraint.create("theta", A, lb=[0.2], ub=[0.2]))
        else:
            traj, pin = dtx.fix_global_variable(traj, "theta", np.asarray(fix_theta))
            cons.append(pin)
        probs.append(dtx.DirectTrajOptProblem.create(traj, obj, bilinear_integrator(),
                                                     constraints=cons))
    prob = jax.tree.map(lambda *xs: jnp.stack(xs), *probs) if B > 1 else probs[0]
    return prob, {
        ("constraint", 0): lambda v: (v[0] - 0.5 * v[-2] - 0.1).reshape(1),
        ("objective", 1): lambda th: ((th - 0.3) ** 2).sum(),
        ("objective", 2): lambda v: 0.02 * (v[1] - v[-1]) ** 2,
    }


PROBLEMS = {
    "time_consistency": lambda: promotion(11),
    "timesteps_all_equal_promotion": lambda: promotion(15, with_t=False, all_equal=True),
    "pinned_final_t": lambda: promotion(13, pin_t=True),
    "minimum_time": minimum_time,
    "duration": duration,
    "duration_range": duration_range,
    "timesteps_all_equal": timesteps_all_equal,
    "symmetry": symmetry,
    "l1_slack": l1_slack,
    "state_constrained": lambda: state_constrained(1, 20),
    "nonlinear_mixed": nonlinear_mixed,
}


def _pade_rollout(u, dt):
    """The rollout of the 2-D transfer by the JAX package's Padé integrator
    (``dtx.bilinear_rollout``), as the fixtures of ``tests/test_riccati.py``
    build their goals."""
    integ = dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", None)
    return np.asarray(dtx.bilinear_rollout(integ, jnp.array([1.0, 0.0]), jnp.asarray(u), dt))


def e2e_l1_free_time():
    """``tests/test_riccati.py::test_e2e_riccati_matches_dense`` (N=14, the
    Padé method): bounds, L1 slacks and free time. Returns ``(problem,
    functions, solve kwargs)``."""
    rng = np.random.default_rng(2)
    N = 14
    u = 0.25 * np.sin(np.linspace(0, 5, N))[:, None]
    xs = _pade_rollout(u, 0.12)
    data = {"x": xs + 0.02 * rng.normal(size=(N, 2)), "u": u, "du": np.zeros((N, 1)),
            "sl": 0.2 * np.ones((N, 1)), "dt": np.full((N, 1), 0.12)}
    traj = dtx.Trajectory.create(
        data, timestep="dt", controls=("u", "du"), initial={"x": [1.0, 0.0]},
        final={"x": xs[-1]}, bounds={"u": 0.8, "sl": (0.0, np.inf), "dt": (0.05, 0.3)})
    integs = [dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", traj),
              dtx.DerivativeIntegrator.create("u", "du", traj)]
    obj = (dtx.QuadraticRegularizer.create("u", traj, 1.0)
           + 0.1 * dtx.LinearRegularizer.create("sl", traj, 1.0)
           + 0.05 * dtx.MinimumTimeObjective.create(traj, 1.0))
    prob = dtx.DirectTrajOptProblem.create(
        traj, obj, integs, constraints=[dtx.L1SlackConstraint.create("du", "sl", traj)])
    return prob, {}, dict(max_iter=300, tol=1e-8, acceptable_tol=1e-4, acceptable_iter=10)


def e2e_strict():
    """``tests/test_riccati.py::test_e2e_riccati_matches_dense_strict`` (N=16)."""
    rng = np.random.default_rng(4)
    N = 16
    u = 0.3 * np.sin(np.linspace(0, 5, N))[:, None]
    xs = _pade_rollout(u, 0.12)
    traj = dtx.Trajectory.create(
        {"x": xs + 0.03 * rng.normal(size=(N, 2)), "u": u}, timestep=0.12, controls="u",
        initial={"x": [1.0, 0.0]}, final={"x": xs[-1]}, bounds={"u": 0.5})
    integ = dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", None)
    prob = dtx.DirectTrajOptProblem.create(traj, dtx.QuadraticRegularizer.create("u", traj, 1.0),
                                           integ)
    return prob, {}, dict(max_iter=200)


def e2e_globals():
    """``tests/test_riccati.py::test_e2e_riccati_matches_dense_globals``
    (N=12): a global phase parameter through a knot equality, a global
    objective and a global knot objective."""
    rng = np.random.default_rng(7)
    N = 12
    u = 0.3 * np.sin(np.linspace(0, 4, N))[:, None]
    xs = _pade_rollout(u, 0.12)
    traj = dtx.Trajectory.create(
        {"x": xs + 0.02 * rng.normal(size=(N, 2)), "u": u}, timestep=0.12, controls="u",
        initial={"x": [1.0, 0.0]}, final={"x": xs[-1]}, bounds={"u": 0.8, "theta": 3.0},
        global_data={"theta": [0.4, -0.2]})
    obj = (dtx.QuadraticRegularizer.create("u", traj, 1.0)
           + dtx.GlobalObjective.create(lambda th: jnp.sum((th - 0.3) ** 2), "theta", traj)
           + dtx.GlobalKnotPointObjective.create(lambda v: 0.02 * (v[1] - v[-1]) ** 2, "x",
                                                 "theta", traj))
    cons = [dtx.NonlinearGlobalKnotPointConstraint.create(
                lambda v: jnp.array([v[0] - 0.5 * v[-2] - 0.1]), "u", "theta", traj, times=[3]),
            dtx.GlobalLinearConstraint.create("theta", np.array([[1.0, 1.0]]), lb=[0.2],
                                              ub=[0.2])]
    prob = dtx.DirectTrajOptProblem.create(
        traj, obj, [dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", traj)],
        constraints=cons)
    return prob, {
        ("constraint", 0): lambda v: (v[0] - 0.5 * v[-2] - 0.1).reshape(1),
        ("objective", 1): lambda th: ((th - 0.3) ** 2).sum(),
        ("objective", 2): lambda v: 0.02 * (v[1] - v[-1]) ** 2,
    }, dict(max_iter=200)


# the end-to-end fixtures of tests/test_riccati.py, with the tolerances at
# which its tests hold the Riccati backend to the dense one: (fixture,
# "objective" rtol or "Z" atol)
E2E = {
    "l1_free_time": (e2e_l1_free_time, ("objective", 5e-3)),
    "strict": (e2e_strict, ("Z", 1e-6)),
    "globals": (e2e_globals, ("Z", 1e-5)),
}
