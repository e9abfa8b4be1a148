"""Benchmark problems and the certified two-stage pipeline.

Counterpart of the bilinear builders of ``directtrajopt_tpu/benchmarks.py``
(the 4-D Pauli state with 2 bounded drives, a u→du→ddu derivative chain and
a free Δt), plus the accelerator configuration of the benchmark's certified
pipeline — ``headline_config``, ``run_headline`` and ``rms_u_vs_golden`` —
which the tests and ``chip_smoke.py`` take from this one place.

``make_batched_state_constrained_problems`` builds the second family: the
2-D bilinear transfer with a state constraint ‖x_k‖² ≤ cap at every knot
(the state-constrained end-to-end problem of the JAX package's tests), one
lane per initial guess. ``make_batched_global_problems`` builds the third:
the same transfer with a global phase parameter θ ∈ ℝ² coupled to the
trajectory through a knot equality, a knot objective and a global objective
(the arrowhead end-to-end problem of the JAX package's tests), one lane per
start. ``scheduled_config`` and ``polished_config`` run the first family
through ``solve_batch_scheduled`` and ``solve_batch_polished`` (path 4 of
``chip_smoke.py``), with ``scheduled_certificate`` and ``telemetry_sound``.
``make_batched_cartpole_problems`` builds the fifth family, the JAX
package's cartpole cart-move (general RK4 dynamics through
``GeneralIntegrator``), one lane per seed; ``cartpole_config`` and
``cartpole_lbfgs_config`` solve it with the exact Hessian and with L-BFGS
(path 5 of ``chip_smoke.py``), certified by ``cartpole_certificate``.
``make_batched_td_problems`` builds the sixth: the 4-D Pauli state under a
time-dependent generator with an order-1 control spline
(``TimeDependentBilinearIntegrator``), which the Riccati backend cannot take,
so ``td_config`` solves it on the dense backend in float64, certified by
``td_certificate``; ``dense_config`` and ``cartpole_dense_lbfgs_config`` run
path 1's and path 5's families on the dense backend (path 6 of
``chip_smoke.py``). ``make_scaled_problem`` and
``make_batched_scaled_problems`` build the seventh, the JAX package's
scaling family (random generators of any state dimension, lane i from seed
42 + i, the batch of its ``bench_sweep.py``), with ``scaled_config`` the
sweep's float32 options (path 7 of ``chip_smoke.py``).

Problems are built on the host in numpy from a seed (the same draws as the
JAX package, so both packages pose the same problems) and put on
``device`` once.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .constraints import (
    GlobalLinearConstraint,
    NonlinearGlobalKnotPointConstraint,
    TimeStepsAllEqualConstraint,
    NonlinearKnotPointConstraint,
)
from .integrators import (
    BilinearIntegrator,
    DerivativeIntegrator,
    GeneralIntegrator,
    TimeDependentBilinearIntegrator,
)
from .objectives import (
    GlobalKnotPointObjective,
    GlobalObjective,
    QuadraticRegularizer,
    TerminalObjective,
)
from .problem import DirectTrajOptProblem
from .rollout import bilinear_rollout
from .trajectory import Trajectory

__all__ = [
    "pauli_generators",
    "make_bilinear_problem",
    "make_batched_bilinear_problems",
    "make_batched_state_constrained_problems",
    "state_constrained_config",
    "state_constrained_certificate",
    "make_batched_global_problems",
    "global_config",
    "global_certificate",
    "headline_config",
    "scheduled_config",
    "polished_config",
    "scheduled_certificate",
    "telemetry_sound",
    "run_headline",
    "rms_u_vs_golden",
    "GOLDEN_N51",
    "GOLDEN_STATE_CONSTRAINED",
    "GOLDEN_GLOBAL_PHASE",
    "GOLDEN_SCHEDULED",
    "cartpole_dynamics",
    "make_cartpole_problem",
    "make_batched_cartpole_problems",
    "cartpole_config",
    "cartpole_lbfgs_config",
    "cartpole_certificate",
    "GOLDEN_CARTPOLE",
    "td_generator",
    "td_data",
    "make_batched_td_problems",
    "td_config",
    "td_certificate",
    "dense_config",
    "cartpole_dense_lbfgs_config",
    "GOLDEN_TD",
    "scaled_data",
    "scaled_trajectory",
    "make_scaled_problem",
    "make_batched_scaled_problems",
    "scaled_config",
    "GOLDEN_SCALED",
    "GOLDEN_SCALED_DIM4",
]

_GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "tests", "golden")
GOLDEN_N51 = os.path.join(_GOLDEN_DIR, "bilinear_n51_seed42.npz")
GOLDEN_STATE_CONSTRAINED = os.path.join(_GOLDEN_DIR, "torch", "state_constrained_n51.npz")
GOLDEN_GLOBAL_PHASE = os.path.join(_GOLDEN_DIR, "torch", "global_phase_n51.npz")
GOLDEN_SCHEDULED = os.path.join(_GOLDEN_DIR, "torch", "scheduled_n51.npz")
GOLDEN_CARTPOLE = os.path.join(_GOLDEN_DIR, "cartpole_n40_seed0.npz")
GOLDEN_TD = os.path.join(_GOLDEN_DIR, "torch", "td_order1_n51.npz")
GOLDEN_SCALED = os.path.join(_GOLDEN_DIR, "torch", "scaled.npz")
GOLDEN_SCALED_DIM4 = os.path.join(_GOLDEN_DIR, "torch", "scaled_dim4.npz")


def _np_bilinear_rollout(G_drift, G_drives, x0, u, dt, order: int = 16):
    """Host-side rollout ``x_{k+1} = exp(Δt G(u_k)) x_k`` by the Taylor–Horner
    chain. Shapes: x0 (..., d), u (..., N, m), dt scalar → (..., N, d)."""
    Gd = np.asarray(G_drift, dtype=np.float64)
    Gv = np.stack([np.asarray(g, dtype=np.float64) for g in G_drives])
    u = np.asarray(u, dtype=np.float64)
    N = u.shape[-2]
    xs = [np.broadcast_to(np.asarray(x0, dtype=np.float64), u.shape[:-2] + Gd.shape[:1]).copy()]
    for k in range(N - 1):
        A = dt * (Gd + np.einsum("...m,mij->...ij", u[..., k, :], Gv))
        x = xs[-1]
        y = x
        for j in range(order, 0, -1):
            y = x + np.einsum("...ij,...j->...i", A, y) / j
        xs.append(y)
    return np.stack(xs, axis=-2)


def pauli_generators():
    """Real 4-D Pauli representation generators."""
    Gx = np.array([[0, 0, 0, 1], [0, 0, 1, 0], [0, -1, 0, 0], [-1, 0, 0, 0]], dtype=float)
    Gy = np.array([[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 0, -1], [0, 0, 1, 0]], dtype=float)
    Gz = np.array([[0, 0, 1, 0], [0, 0, 0, -1], [-1, 0, 0, 0], [0, 1, 0, 0]], dtype=float)
    return Gx, Gy, Gz


def _bilinear_problem(data: dict, *, device, dtype, free_time: bool, taylor_order: int,
                      goal_objective: float | None = None,
                      dt: float = 0.1, u_bound: float = 0.1, omega: float = 0.1):
    """Assemble the bilinear problem around per-lane data (B, N, ·)."""
    Gx, Gy, Gz = pauli_generators()
    B = data["x"].shape[0]
    bounds = {"u": u_bound}
    if free_time:
        bounds["dt"] = (0.01, 0.5)
    traj = Trajectory.create(
        data,
        timestep="dt" if free_time else dt,
        controls=("ddu", "dt") if free_time else ("ddu",),
        initial={"x": [1.0, 0.0, 0.0, 0.0], "u": np.zeros(2)},
        final={"u": np.zeros(2)},
        goal={"x": [0.0, 1.0, 0.0, 0.0]},
        bounds=bounds,
        device=device,
        dtype=dtype,
    )
    integrators = [
        BilinearIntegrator.create((omega * Gz, [Gx, Gy]), "x", "u", batch=B, device=device,
                                  dtype=dtype, method="taylor", taylor_order=taylor_order),
        DerivativeIntegrator.create("u", "du"),
        DerivativeIntegrator.create("du", "ddu"),
    ]
    obj = QuadraticRegularizer.create("u", traj, 1.0) + QuadraticRegularizer.create("du", traj, 1.0)
    if goal_objective is not None:
        goal = torch.tensor([0.0, 1.0, 0.0, 0.0], dtype=dtype, device=device)
        obj = obj + TerminalObjective(lambda x: ((x - goal) ** 2).sum(), "x", traj,
                                      Q=goal_objective)
    return DirectTrajOptProblem.create(traj, obj, integrators)


def make_bilinear_problem(N: int = 51, seed: int = 42, *, device=None, dtype=torch.float64,
                          free_time: bool = True, goal_objective: float | None = None,
                          feasible_start: bool = False,
                          taylor_order: int = 12) -> DirectTrajOptProblem:
    """The standard bilinear quantum-gate problem, as one lane.
    ``goal_objective``: weight Q of a terminal cost Q·‖x_N − goal‖²."""
    rng = np.random.default_rng(seed)
    dt, u_bound, omega = 0.1, 0.1, 0.1
    Gx, Gy, Gz = pauli_generators()
    u0 = u_bound * (2 * rng.random((N, 2)) - 1)
    if feasible_start:
        x0 = _np_bilinear_rollout(omega * Gz, [Gx, Gy], np.array([1.0, 0.0, 0.0, 0.0]), u0, dt)
    else:
        x0 = 2 * rng.random((N, 4)) - 1
    data = {"x": x0, "u": u0, "du": rng.standard_normal((N, 2)),
            "ddu": rng.standard_normal((N, 2))}
    if free_time:
        data["dt"] = np.full((N, 1), dt)
    data = {k: v[None] for k, v in data.items()}
    return _bilinear_problem(data, device=device, dtype=dtype, free_time=free_time,
                             taylor_order=taylor_order, goal_objective=goal_objective)


def make_batched_bilinear_problems(batch: int, N: int = 51, seed: int = 42, *, device=None,
                                   dtype=torch.float64, free_time: bool = True,
                                   feasible_start: bool = False,
                                   goal_objective: float | None = None,
                                   taylor_order: int = 12) -> DirectTrajOptProblem:
    """A batch of bilinear problems differing in initial controls and state
    data — the same draws as the JAX package's builder of that name."""
    rng = np.random.default_rng(seed)
    dt, u_bound, omega = 0.1, 0.1, 0.1
    Gx, Gy, Gz = pauli_generators()
    u0 = u_bound * (2 * rng.random((batch, N, 2)) - 1)
    if feasible_start:
        x0 = _np_bilinear_rollout(omega * Gz, [Gx, Gy], np.array([1.0, 0.0, 0.0, 0.0]), u0, dt)
    else:
        x0 = 2 * rng.random((batch, N, 4)) - 1
    data = {"x": x0, "u": u0, "du": rng.standard_normal((batch, N, 2)),
            "ddu": rng.standard_normal((batch, N, 2))}
    if free_time:
        data["dt"] = np.full((batch, N, 1), dt)
    return _bilinear_problem(data, device=device, dtype=dtype, free_time=free_time,
                             taylor_order=taylor_order, goal_objective=goal_objective)


# the 2-D bilinear transfer of the state-constrained family
SC_G_DRIFT = np.array([[0.0, 1.0], [-1.0, 0.0]])
SC_G_DRIVE = np.array([[0.0, 1.0], [1.0, 0.0]])


def scaled_data(batch: int, N: int, state_dim: int, n_controls: int = 2, seed: int = 42):
    """The scaling family's host draws for lanes seed … seed + batch − 1, each
    from its own ``np.random.default_rng`` in the JAX package's order
    (``make_scaled_problem``): G_drift (batch, n, n), G_drives (batch, m,
    n, n) and the guesses x (batch, N, n), u, du (batch, N, m), Δt ≡ 0.1."""
    Gd, Gv, data = [], [], {"x": [], "u": [], "du": []}
    for lane in range(batch):
        rng = np.random.default_rng(seed + lane)
        Gd.append(rng.standard_normal((state_dim, state_dim)))
        Gv.append(np.stack([rng.standard_normal((state_dim, state_dim))
                            for _ in range(n_controls)]))
        data["x"].append(rng.standard_normal((N, state_dim)))
        data["u"].append(0.1 * rng.standard_normal((N, n_controls)))
        data["du"].append(rng.standard_normal((N, n_controls)))
    data = {k: np.stack(v) for k, v in data.items()}
    data["dt"] = np.full((batch, N, 1), 0.1)
    return np.stack(Gd), np.stack(Gv), data


def scaled_trajectory(data: dict, *, device, dtype) -> Trajectory:
    """The scaling family's trajectory around per-lane data (B, N, ·): x
    from e₀, u pinned to 0 at both ends, |u| ≤ 1, Δt ∈ [0.01, 0.5] free,
    controls du and Δt."""
    n, m = data["x"].shape[-1], data["u"].shape[-1]
    x_init = np.zeros(n)
    x_init[0] = 1.0
    return Trajectory.create(data, timestep="dt", controls=("du", "dt"),
                             initial={"x": x_init, "u": np.zeros(m)}, final={"u": np.zeros(m)},
                             bounds={"u": 1.0, "dt": (0.01, 0.5)}, device=device, dtype=dtype)


def make_batched_scaled_problems(batch: int, N: int, state_dim: int, n_controls: int = 2,
                                 seed: int = 42, *, device=None,
                                 dtype=torch.float64) -> DirectTrajOptProblem:
    """The JAX package's ``make_scaled_problem`` (the reference's
    ``problem_utils.jl:44-77``) for seeds seed … seed + batch − 1, one lane
    each: ``x_{k+1} = exp(Δt_k G(u_k)) x_k`` with random G_drift and
    G_drives (the integrator's default method, Padé), u → du a derivative
    chain, objective ½Σ‖u_k‖²."""
    Gd, Gv, data = scaled_data(batch, N, state_dim, n_controls, seed)
    traj = scaled_trajectory(data, device=device, dtype=dtype)
    integrators = [
        BilinearIntegrator.create((Gd, Gv), "x", "u", batch=batch, device=device, dtype=dtype),
        DerivativeIntegrator.create("u", "du"),
    ]
    return DirectTrajOptProblem.create(traj, QuadraticRegularizer.create("u", traj, 1.0),
                                       integrators)


def make_scaled_problem(N: int, state_dim: int, n_controls: int = 2, seed: int = 42, *,
                        device=None, dtype=torch.float64) -> DirectTrajOptProblem:
    """One lane of :func:`make_batched_scaled_problems`: the JAX package's
    ``make_scaled_problem(N, state_dim, n_controls, seed)``."""
    return make_batched_scaled_problems(1, N, state_dim, n_controls, seed, device=device,
                                        dtype=dtype)


def scaled_config() -> dict:
    """Path 7: the scaling family at N=51 through ``solve_batch_compact`` with
    the float32 options of the JAX package's ``bench_sweep.py`` (tol 1e-5,
    acceptable_tol 5e-4 after 5 iterations, Gauss-Newton Hessian,
    kappa_epsilon 100, kappa_mu 0.1; straggler phases of 20, 30, 72 and
    256 iterations, the later ones restarting μ at 1e-3, in chunks of 128
    lanes) on one chunk of 128 lanes. Returns ``{"N", "batch", "solve_kw"}``."""
    return dict(N=51, batch=128, solve_kw=dict(
        tol=1e-5, acceptable_tol=5e-4, acceptable_iter=5, hessian_approximation="gauss_newton",
        kappa_epsilon=100.0, kappa_mu=0.1,
        phases=((20, None), (30, 1e-3), (72, 1e-3), (256, 1e-3)), chunk=128))


def make_batched_state_constrained_problems(batch: int, N: int = 51, seed0: int = 0, *,
                                            device=None,
                                            dtype=torch.float64, dt: float = 0.15,
                                            u_scale: float = 0.3, cap: float | None = None,
                                            taylor_order: int = 12) -> DirectTrajOptProblem:
    """The state-constrained bilinear transfer, one lane per initial guess.

    ``x_{k+1} = exp(Δt (G_d + u_k G_u)) x_k`` (2-D state, 1 drive, fixed Δt)
    from x_0 = (1, 0) to the final state of a rollout under
    ``u = u_scale·sin(2πk/(N−1))``, minimizing ½Σ‖Δt u_k‖², subject to
    ``‖x_k‖² ≤ cap`` at every knot. Lane ℓ starts from the rollout plus
    noise from ``np.random.default_rng(seed0 + ℓ)`` (0.05·N(0,1) on x, then
    on u); the cap, unless given, is lane 0's max ‖x_k‖² plus 0.2, shared by
    all lanes.
    Built on the host in float64, then put on ``device`` once."""
    u = u_scale * np.sin(np.linspace(0, 2 * np.pi, N))[:, None]
    x0 = np.array([1.0, 0.0])
    xs = _host_rollout(x0, u, dt)
    xg, ug = [], []
    for lane in range(batch):
        rng = np.random.default_rng(seed0 + lane)
        xg.append(xs + 0.05 * rng.normal(size=(N, 2)))
        ug.append(u + 0.05 * rng.normal(size=(N, 1)))
    if cap is None:
        cap = float(np.max(np.sum(xg[0] ** 2, axis=1))) + 0.2
    traj = Trajectory.create({"x": np.stack(xg), "u": np.stack(ug)}, timestep=dt, controls="u",
                             initial={"x": x0}, final={"x": xs[-1]}, device=device, dtype=dtype)
    integ = BilinearIntegrator.create((SC_G_DRIFT, [SC_G_DRIVE]), "x", "u", batch=batch,
                                      device=device, dtype=dtype, method="taylor",
                                      taylor_order=taylor_order)
    con = NonlinearKnotPointConstraint.create(
        lambda x: (x * x).sum(-1, keepdim=True) - cap, "x", traj, equality=False)
    return DirectTrajOptProblem.create(traj, QuadraticRegularizer.create("u", traj, 1.0), integ,
                                       constraints=[con])


def state_constrained_certificate(res, path: str = GOLDEN_STATE_CONSTRAINED):
    """Per-lane max |u − u*| against the float64 optimum of the family
    (every lane poses the same problem from a different start) and max
    (‖x_k‖² − cap) over the knots. Returns two arrays over the lanes."""
    data = np.load(path)
    layout = res.problem.trajectory.layout
    N, d = int(data["N"]), layout.dim
    u_star = np.asarray(data["Z_star"], dtype=np.float64)[: N * d].reshape(N, d)[
        :, layout.comp_slice("u")]
    u = res.problem.trajectory.data["u"].detach().to("cpu", torch.float64).numpy()
    x = res.problem.trajectory.data["x"].detach().to("cpu", torch.float64).numpy()
    err = np.abs(u - u_star[None]).max(axis=(1, 2))
    viol = (x**2).sum(-1).max(-1) - float(data["cap"])
    return err, viol


def _host_rollout(x0, u, dt):
    """The 2-D transfer's rollout on the host, in float64: (N, 2)."""
    host = BilinearIntegrator.create((SC_G_DRIFT, [SC_G_DRIVE]), "x", "u", batch=1, device="cpu")
    return bilinear_rollout(host, torch.as_tensor(x0)[None], torch.as_tensor(u)[None], dt)[0].numpy()


def make_batched_global_problems(batch: int, N: int = 51, seed0: int = 0, *, device=None,
                                 dtype=torch.float64, dt: float = 0.12,
                                 taylor_order: int = 12) -> DirectTrajOptProblem:
    """The global-phase family, one lane per start.

    The 2-D transfer ``x_{k+1} = exp(Δt (G_d + u_k G_u)) x_k`` (fixed Δt,
    |u| ≤ 0.8) from x_1 = (1, 0) to the final state of the rollout of
    ``u = 0.3·sin(linspace(0, 4, N))``, with a global θ ∈ ℝ² (|θ| ≤ 3);
    objective ½Σ‖Δt u_k‖² + Σ(θ − 0.3)² + Σ_k 0.02·(x_k[1] − θ[1])²;
    constraints u_3 − 0.5·θ[0] − 0.1 = 0 (a global-coupled knot equality)
    and θ[0] + θ[1] = 0.2 (a global linear row). Lane ℓ starts from the
    rollout plus 0.02·N(0,1) on x and from θ = (0.4, −0.2) plus 0.2·N(0,1),
    both from ``np.random.default_rng(seed0 + ℓ)``; every lane poses the
    same problem. Built on the host in float64, then put on ``device`` once."""
    u = 0.3 * np.sin(np.linspace(0, 4, N))[:, None]
    x0 = np.array([1.0, 0.0])
    xs = _host_rollout(x0, u, dt)
    xg, thg = [], []
    for lane in range(batch):
        rng = np.random.default_rng(seed0 + lane)
        xg.append(xs + 0.02 * rng.normal(size=(N, 2)))
        thg.append(np.array([0.4, -0.2]) + 0.2 * rng.normal(size=2))
    traj = Trajectory.create(
        {"x": np.stack(xg), "u": np.repeat(u[None], batch, axis=0)}, timestep=dt, controls="u",
        initial={"x": x0}, final={"x": xs[-1]}, bounds={"u": 0.8, "theta": 3.0},
        global_data={"theta": np.stack(thg)}, device=device, dtype=dtype)
    integ = BilinearIntegrator.create((SC_G_DRIFT, [SC_G_DRIVE]), "x", "u", batch=batch,
                                      device=device, dtype=dtype, method="taylor",
                                      taylor_order=taylor_order)
    obj = (QuadraticRegularizer.create("u", traj, 1.0)
           + GlobalObjective.create(lambda th: ((th - 0.3) ** 2).sum(), "theta", traj)
           + GlobalKnotPointObjective.create(lambda v: 0.02 * (v[1] - v[-1]) ** 2, "x",
                                             "theta", traj))
    cons = [
        NonlinearGlobalKnotPointConstraint.create(
            lambda v: (v[0] - 0.5 * v[-2] - 0.1).reshape(1), "u", "theta", traj, times=[3]),
        GlobalLinearConstraint.create("theta", np.array([[1.0, 1.0]]), lb=[0.2], ub=[0.2],
                                      traj=traj),
    ]
    return DirectTrajOptProblem.create(traj, obj, integ, constraints=cons)


def global_certificate(res, path: str = GOLDEN_GLOBAL_PHASE):
    """Per-lane max |u − u*| and max |θ − θ*| against the float64 optimum of
    the global-phase family (tol 1e-10), the residuals |θ[0] + θ[1] − 0.2|
    and |u_3 − 0.5·θ[0] − 0.1| of its two equalities, and, for the first
    lanes (as many as the golden holds, 64), max |Z − Z_ref| against the JAX
    package's float64 solve of the same lanes at :func:`global_config`'s
    options (tol 1e-6). The last holds only for a batch built with
    ``seed0 = 0``. Five arrays; the first four over all lanes."""
    data = np.load(path)
    traj = res.problem.trajectory
    layout = traj.layout
    N, d = int(data["N"]), layout.dim
    Zs = np.asarray(data["Z_star"], dtype=np.float64)
    u_star = Zs[: N * d].reshape(N, d)[:, layout.comp_slice("u")]
    th_star = Zs[N * d :][layout.global_slice("theta")]
    u = traj.data["u"].detach().to("cpu", torch.float64).numpy()
    th = traj.global_data["theta"].detach().to("cpu", torch.float64).numpy()
    err_u = np.abs(u - u_star[None]).max(axis=(1, 2))
    err_th = np.abs(th - th_star[None]).max(axis=1)
    lin = np.abs(th[:, 0] + th[:, 1] - 0.2)
    eq3 = np.abs(u[:, 3, 0] - 0.5 * th[:, 0] - 0.1)
    Z_ref = np.asarray(data["Z_ref"], dtype=np.float64)
    n_ref = min(len(u), len(Z_ref))
    Z = traj.to_zvec()[:n_ref].detach().to("cpu", torch.float64).numpy()
    err_ref = np.abs(Z - Z_ref[:n_ref]).max(axis=1)
    return err_u, err_th, lin, eq3, err_ref


def global_config() -> dict:
    """The global-phase family's solve on the card: the options of
    :func:`state_constrained_config` (one float32 phase of 40 iterations,
    exact Hessian with ``hessian_regularization="auto"``, compensated
    residuals, tol = acceptable_tol = 1e-6, one chunk of ``batch`` lanes)
    with ``delta_c = 1e-7``. At the default 1e-8 the JAX package's own
    float32 solve fails every lane (restoration failed after 10-11
    iterations), and the port with it: the linear row θ[0] + θ[1] = 0.2 has
    no knot part, so its Schur pivot is δ_c alone and its term W₁ᵀM⁻¹W₁ ≈
    1e8 swamps the reduced global Hessian T in float32; T's Cholesky then
    fails at every δ_w. Returns ``{"N", "batch", "solve_kw"}``."""
    cfg = state_constrained_config()
    cfg["solve_kw"]["delta_c"] = 1e-7
    return cfg


def state_constrained_config() -> dict:
    """The state-constrained family's solve on the card: one f32 phase of
    40 iterations, exact Hessian with ``hessian_regularization="auto"``,
    compensated residuals, tol = acceptable_tol = 1e-6, one chunk of
    ``batch`` lanes. Returns ``{"N", "batch", "solve_kw"}`` with full
    kwargs for ``solve_batch_compact``."""
    B = 8192
    return dict(N=51, batch=B, solve_kw=dict(
        phases=((40, None),), chunk=B, tol=1e-6, acceptable_tol=1e-6,
        compensated_residuals=True))


def headline_config(batch: int | None = None) -> dict:
    """The certified two-stage pipeline of the benchmark, accelerator
    configuration (float32, Taylor order 6).

    1. **Seek** — Gauss-Newton IPM to tol 1e-6 with straggler phases that
       restart μ at 1e-2, a 7-slot trial grid and no SOC / restoration.
    2. **Polish** — exact-Hessian IPM warm-started per lane from the seek's
       best-KKT slacks and duals (``carry_duals`` threads them through the
       phases), plain inertia regularization, compensated float32 residual
       arithmetic, tol 1e-7; SOC and restoration on (the defaults).

    Returns ``{"N", "batch", "taylor_order", "phase1_kw", "polish_kw"}``;
    the ``*_kw`` dicts are full kwargs for ``solve_batch_compact``.
    """
    B = batch if batch is not None else 8192
    chunk = min(256, B)
    phase1_kw = dict(
        tol=1e-6,
        acceptable_tol=1e-6,
        acceptable_iter=50,
        mu_init=3e-2,
        hessian_approximation="gauss_newton",
        phases=((20, None), (20, 1e-2), (96, 1e-2)),
        chunk=chunk,
        max_ls=7,
        n_rest_trials=0,
        max_soc=0,
    )
    polish_kw = dict(
        tol=1e-7,
        acceptable_tol=1e-7,
        mu_init=1e-5,
        bound_push=1e-9,
        bound_frac=1e-9,
        phases=((2, None), (6, None)),
        chunk=chunk,
        carry_duals=True,
        hessian_regularization="inertia",
        compensated_residuals=True,
    )
    return dict(N=51, batch=B, taylor_order=6, phase1_kw=phase1_kw, polish_kw=polish_kw)


def scheduled_config() -> dict:
    """Path 4a: ``solve_batch_scheduled`` on path 1's family (float32,
    Taylor order 6, B=8192) with the seek's options; ``phase1_iter`` 24 (the
    scheduler's default), ``phase2_iter`` 112 (a lane's budget is the
    seek's 20 + 20 + 96 = 136), the barrier restarted at the seek's 1e-2,
    path 1's chunk of 256, and a 32-row telemetry ring. Returns ``{"N",
    "batch", "taylor_order", "solve_kw"}``."""
    from .solvers.callbacks import telemetry

    kw = {k: v for k, v in headline_config()["phase1_kw"].items() if k not in ("phases", "chunk")}
    kw.update(phase1_iter=24, phase2_iter=112, mu_init_phase2=1e-2, chunk=256,
              callbacks=telemetry(32))
    return dict(N=51, batch=8192, taylor_order=6, solve_kw=kw)


def polished_config() -> dict:
    """Path 4b: ``solve_batch_polished`` on lanes 0-1023 of path 1's family
    with the options of the JAX package's N=51 polish test (exact Hessian,
    tol = acceptable_tol = 1e-6, acceptable_iter 100, mu_init 3e-2;
    polish_tol 1e-8, polish_mu_init 1e-5), the float32 phase's budget
    raised from the test's 150 to 300 iterations and the polish capped at
    40. The test poses one problem; from this family's starts the exact
    Hessian is slower: at 150 iterations 5 of lanes 0-63 are still running
    in either package (f32, CPU), and the polish, a lockstep batch on the
    kernels' plain float64 versions, cannot finish them. At 300 all 64
    converge (the slowest in 160) and the polish takes at most 2
    iterations. Returns ``{"N", "batch", "taylor_order", "solve_kw"}``."""
    kw = dict(tol=1e-6, acceptable_tol=1e-6, acceptable_iter=100, max_iter=300, mu_init=3e-2,
              polish_max_iter=40)
    return dict(N=51, batch=1024, taylor_order=6, solve_kw=kw)


def scheduled_certificate(res, path: str = GOLDEN_SCHEDULED):
    """Against the JAX package's float64 ``solve_batch_scheduled`` of lanes
    0-63 (as many as the golden holds) at :func:`scheduled_config`'s
    options: max |z − z_ref| over the components the optimum determines
    (u, du, ddu), and over all of Z. The optimum is u ≡ 0, at which every
    Δt is optimal: Δt and the rolled-out x are not determined (Z_ref's Δt
    spans 0.253-0.270 over the lanes), and a float32 solve at tol 1e-6
    stops elsewhere along that valley than a float64 one, in the JAX package
    too (1.4e-2 in Δt on lanes 0-7). Two floats."""
    Z_ref = np.asarray(np.load(path)["Z_ref"], dtype=np.float64)
    n = min(res.converged.shape[0], len(Z_ref))
    layout = res.problem.trajectory.layout
    Z = res.problem.trajectory.to_zvec()[:n].detach().to("cpu", torch.float64).numpy()
    diff = np.abs(Z - Z_ref[:n]).reshape(n, layout.N, layout.dim)
    det = np.concatenate([diff[..., layout.comp_slice(c)] for c in ("u", "du", "ddu")], axis=-1)
    return float(det.max()), float(diff.max())


def telemetry_sound(res) -> np.ndarray:
    """Per lane, whether its telemetry ring (``res.ipm.history_stats``, T
    rows) is sound. With n the iterations of the phase that produced the
    lane's result (``res.ipm.iterations``): the rows of iterations
    max(0, n − T + 1) … n − 1 (each written by a step) are finite and their
    μ column never increases, in iteration order; row n (the final iterate,
    written when the lane stopped on convergence) is finite or zero; the
    rows after it are zero."""
    ring = res.ipm.history_stats.detach().to("cpu", torch.float64).numpy()
    its = res.ipm.iterations.cpu().numpy()
    T = ring.shape[1]
    mu_col = 3  # TELEMETRY_COLUMNS.index("mu")
    ok = np.zeros(len(its), dtype=bool)
    for lane, n in enumerate(its):
        steps = ring[lane, [i % T for i in range(max(0, n - T + 1), n)]]
        good = np.isfinite(steps).all() and bool((np.diff(steps[:, mu_col]) <= 0).all())
        if n < T:
            good = good and np.isfinite(ring[lane, n]).all() and not ring[lane, n + 1:].any()
        ok[lane] = good
    return ok


def run_headline(batch_problems, cfg, times: dict | None = None):
    """Seek, then polish. Returns ``(res_polish, res_seek)``.

    If ``times`` is given, it receives each stage's wall seconds under
    ``"seek"`` and ``"polish"``, each ending once the device has finished."""
    from .solvers.solve import solve_batch_compact

    def stage(fn):
        t0 = time.perf_counter()
        res = fn()
        if res.converged.is_cuda:
            torch.cuda.synchronize(res.converged.device)
        return res, time.perf_counter() - t0

    res1, t_seek = stage(lambda: solve_batch_compact(batch_problems, **cfg["phase1_kw"]))
    res2, t_polish = stage(lambda: solve_batch_compact(
        res1.problem, warm=res1.ipm.state.best_kkt_warm, **cfg["polish_kw"]))
    if times is not None:
        times.update(seek=t_seek, polish=t_polish)
    return res2, res1


def rms_u_vs_golden(res, lanes=None, path: str = GOLDEN_N51) -> np.ndarray:
    """Per-lane RMS(u − u*) against the certified N=51 optimum (scipy
    trust-constr, f64). Every lane of the batched benchmark poses the same
    optimization problem from a different start, so one optimum covers all
    lanes. Returns an array over the selected lanes."""
    data = np.load(path)
    Zg = np.asarray(data["Z_star"], dtype=np.float64)
    layout = res.problem.trajectory.layout
    d = layout.dim
    u_g = Zg[: int(data["N"]) * d].reshape(int(data["N"]), d)[:, layout.comp_slice("u")]
    u = res.problem.trajectory.data["u"].detach().to("cpu", torch.float64).numpy()
    if lanes is not None:
        u = u[np.asarray(lanes)]
    return np.sqrt(np.mean((u - u_g[None]) ** 2, axis=(1, 2)))


def cartpole_dynamics(mc: float = 1.0, mp: float = 0.2, length: float = 0.5,
                      grav: float = 9.81):
    """Continuous cartpole dynamics ẋ = f(x, u), x = [p, ṗ, θ, θ̇], θ = 0
    upright: a torch function of one knot's x (4,) and u (1,), in their
    dtype (the JAX package's ``cartpole_dynamics``, in the same order of
    operations)."""

    def f(x, u):
        dp, th, dth = x[1], x[2], x[3]
        F = u[0]
        sin, cos = torch.sin(th), torch.cos(th)
        denom = mc + mp * sin**2
        ddp = (F + mp * sin * (length * dth**2 + grav * cos)) / denom
        ddth = (-F * cos - mp * length * dth**2 * cos * sin - (mc + mp) * grav * sin) / (
            length * denom)
        return torch.stack([dp, ddp, dth, ddth])

    return f


def _cartpole_guess(N: int, seed: int, goal_p: float):
    """The JAX package's cartpole guess for ``seed``: the same draws in the
    same order (x then u), so a seed gives its guess bit for bit at f64."""
    rng = np.random.default_rng(seed)
    x0, goal = np.zeros(4), np.array([goal_p, 0.0, 0.0, 0.0])
    x = np.linspace(x0, goal, N) + 0.01 * rng.standard_normal((N, 4))
    u = 0.1 * rng.standard_normal((N, 1))
    return x, u


def make_batched_cartpole_problems(batch: int, N: int = 40, seed0: int = 0, *, device=None,
                                   dtype=torch.float64, dt: float = 0.05, goal_p: float = 1.0,
                                   u_bound: float = 10.0) -> DirectTrajOptProblem:
    """The cartpole cart-move family, lane i from seed ``seed0 + i``.

    Start balanced upright at p = 0 (x_1 pinned), end near p = ``goal_p``
    through a terminal cost 100·‖x_N − goal‖² plus the regularizer
    ½·0.1·Σ‖Δt u_k‖², |u| ≤ ``u_bound``, fixed Δt, one RK4 step per window
    (the JAX package's ``make_cartpole_problem``; a seed perturbs only the
    guess, so every lane poses the same problem). Its terminal cost computes
    in the iterate's dtype. Built on the host in float64, then put on
    ``device`` once."""
    guesses = [_cartpole_guess(N, seed0 + i, goal_p) for i in range(batch)]
    goal = np.array([goal_p, 0.0, 0.0, 0.0])
    traj = Trajectory.create(
        {"x": np.stack([g[0] for g in guesses]), "u": np.stack([g[1] for g in guesses])},
        timestep=dt, controls="u", initial={"x": np.zeros(4)}, bounds={"u": u_bound},
        device=device, dtype=dtype)
    integ = GeneralIntegrator.create(cartpole_dynamics(), "x", "u", scheme="rk4")

    def ell(x):
        return ((x - torch.as_tensor(goal, dtype=x.dtype, device=x.device)) ** 2).sum()

    obj = QuadraticRegularizer.create("u", traj, 0.1) + TerminalObjective(ell, "x", traj, Q=100.0)
    return DirectTrajOptProblem.create(traj, obj, integ)


def make_cartpole_problem(N: int = 40, seed: int = 0, *, device=None, dtype=torch.float64,
                          dt: float = 0.05, goal_p: float = 1.0,
                          u_bound: float = 10.0) -> DirectTrajOptProblem:
    """The cartpole cart-move problem from ``seed``'s guess, as one lane."""
    return make_batched_cartpole_problems(1, N, seed, device=device, dtype=dtype, dt=dt,
                                          goal_p=goal_p, u_bound=u_bound)


def cartpole_config() -> dict:
    """Path 5a: the cartpole family on the card, exact Hessian: float32,
    tol = acceptable_tol = 1e-5, 100 iterations, one chunk of ``batch``
    lanes (lane i from seed i). The JAX package's float32 solve of lanes
    0-15 converges every lane in 8 iterations. Returns ``{"N", "batch",
    "solve_kw"}`` with full kwargs for ``solve_batch_compact``."""
    B = 8192
    return dict(N=40, batch=B, solve_kw=dict(
        phases=((100, None),), chunk=B, tol=1e-5, acceptable_tol=1e-5))


def cartpole_lbfgs_config() -> dict:
    """Path 5b: the same family with L-BFGS (``limited_memory_max_history``
    20, the options of the JAX package's batched L-BFGS test): float32, tol
    = acceptable_tol = 1e-4, 300 iterations, one chunk. The Riccati backend
    applies the quasi-Newton model's low-rank part by an SMW correction
    through K2 at 2m = 40 right-hand sides. At float32 this is the setting
    that converges: the JAX package converges 16/16 lanes in 25-64
    iterations (at m = 6 or tol 1e-5 it does not)."""
    B = 8192
    return dict(N=40, batch=B, solve_kw=dict(
        phases=((300, None),), chunk=B, tol=1e-4, acceptable_tol=1e-4,
        hessian_approximation="lbfgs", limited_memory_max_history=20))


def cartpole_certificate(res, path: str = GOLDEN_CARTPOLE):
    """Per lane, |obj/obj* − 1| and RMS(u − u*) against the float64 optimum
    of the family (``tests/golden/cartpole_n40_seed0.npz``; the three seeds'
    goldens agree on obj* to 1e-12). The objective is re-evaluated in
    float64 at the lane's solution. Two arrays over the lanes."""
    from .solvers.canonical import make_nlp
    from .solvers.solve import cast_problem

    data = np.load(path)
    layout = res.problem.trajectory.layout
    N, d = int(data["N"]), layout.dim
    u_star = np.asarray(data["Z_star"], dtype=np.float64)[: N * d].reshape(N, d)[
        :, layout.comp_slice("u")]
    p64 = cast_problem(res.problem, torch.float64)
    obj = make_nlp(p64).objective(p64.trajectory.to_zvec()).cpu().numpy()
    u = p64.trajectory.data["u"].cpu().numpy()
    rms = np.sqrt(np.mean((u - u_star[None]) ** 2, axis=(1, 2)))
    return np.abs(obj / float(data["obj"]) - 1.0), rms


# the time-dependent family: G(u, t) = (1 + TD_AMP·sin t)·TD_OMEGA·G_z + u₀G_x + u₁G_y
TD_OMEGA, TD_AMP = 0.1, 0.2
TD_DT, TD_U_GUESS, TD_X_NOISE = 0.1, 0.3, 0.05
TD_N_STEPS = 6


def td_generator():
    """The family's generator ``G(u, t)``: a torch function of one knot's u
    (2,) and a scalar t, in u's dtype (its constants are made once per
    dtype and device)."""
    Gx, Gy, Gz = pauli_generators()
    consts: dict = {}

    def G(u, t):
        key = (u.dtype, u.device)
        if key not in consts:
            consts[key] = tuple(torch.as_tensor(a, dtype=u.dtype, device=u.device)
                                for a in (TD_OMEGA * Gz, Gx, Gy))
        gz, gx, gy = consts[key]
        return (1.0 + TD_AMP * torch.sin(t)) * gz + u[0] * gx + u[1] * gy

    return G


def _np_td_rollout(x0, u, dt: float, n_steps: int = TD_N_STEPS):
    """Host rollout of the family's dynamics by the integrator's own chain
    (``n_steps`` RK4 steps a window, u linear between knots, t_k = k·Δt).
    Shapes: x0 (4,), u (B, N, 2) → (B, N, 4)."""
    Gx, Gy, Gz = pauli_generators()
    B, N = u.shape[:2]
    xs = [np.broadcast_to(np.asarray(x0, dtype=np.float64), (B, 4)).copy()]
    h = 1.0 / n_steps
    for k in range(N - 1):
        t0, u0, u1 = k * dt, u[:, k], u[:, k + 1]

        def ode(y, tau):
            uu = u0 + tau * (u1 - u0)
            G = ((1.0 + TD_AMP * np.sin(t0 + tau * dt)) * TD_OMEGA * Gz
                 + uu[:, 0, None, None] * Gx + uu[:, 1, None, None] * Gy)
            return dt * np.einsum("bij,bj->bi", G, y)

        y = xs[-1]
        for i in range(n_steps):
            tau0 = i * h
            k1 = ode(y, tau0)
            k2 = ode(y + 0.5 * h * k1, tau0 + 0.5 * h)
            k3 = ode(y + 0.5 * h * k2, tau0 + 0.5 * h)
            k4 = ode(y + h * k3, tau0 + h)
            y = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        xs.append(y)
    return np.stack(xs, axis=1)


def td_data(batch: int, N: int = 51, seed0: int = 0) -> dict:
    """The time-dependent family's host data, lane i from seed ``seed0 + i``:
    controls u uniform in ±0.3 drawn, the state path rolled out from
    x_1 = (1, 0, 0, 0) at Δt = 0.1 under them (its last state is the lane's
    pinned x_N, so every lane is feasible), then 0.05·N(0, 1) noise on that
    path for the guess, with u = 0, Δt = 0.1 and t_k = k·Δt. Returns
    ``{"x", "u", "t", "dt", "x_final"}`` with a lane axis."""
    u_roll, noise = [], []
    for i in range(batch):
        rng = np.random.default_rng(seed0 + i)
        u_roll.append(TD_U_GUESS * (2 * rng.random((N, 2)) - 1))
        noise.append(TD_X_NOISE * rng.standard_normal((N, 4)))
    xs = _np_td_rollout(np.array([1.0, 0.0, 0.0, 0.0]), np.stack(u_roll), TD_DT)
    t = np.broadcast_to(np.arange(N, dtype=np.float64)[:, None] * TD_DT, (batch, N, 1))
    return dict(x=xs + np.stack(noise), u=np.zeros((batch, N, 2)), t=t.copy(),
                dt=np.full((batch, N, 1), TD_DT), x_final=xs[:, -1])


def make_batched_td_problems(batch: int, N: int = 51, seed0: int = 0, *, device=None,
                             dtype=torch.float64) -> DirectTrajOptProblem:
    """The time-dependent family (see :func:`td_data`): x ∈ ℝ⁴, u ∈ ℝ² with
    |u| ≤ 0.5, a time component t and a free Δt in (0.05, 0.2), equal at
    every knot (``TimeStepsAllEqualConstraint``: a uniform grid whose length
    is free), tied by the time-consistency rows the problem injects; x_1 = (1, 0, 0, 0) and t_1 = 0 pinned,
    x_N pinned to the lane's rollout; dynamics
    ``TimeDependentBilinearIntegrator(td_generator(), spline_order=1,
    n_steps=6)`` with no derivative chain, so the problem is not
    Riccati-eligible; objective ``QuadraticRegularizer("u")``."""
    data = td_data(batch, N, seed0)
    x_final = data.pop("x_final")
    traj = Trajectory.create(
        data, timestep="dt", controls=("u",),
        initial={"x": [1.0, 0.0, 0.0, 0.0], "t": [0.0]}, final={"x": x_final},
        bounds={"u": 0.5, "dt": (0.05, 0.2)}, device=device, dtype=dtype)
    td = TimeDependentBilinearIntegrator.create(td_generator(), "x", "u", "t", traj,
                                                spline_order=1, n_steps=TD_N_STEPS)
    return DirectTrajOptProblem.create(traj, QuadraticRegularizer.create("u", traj, 1.0), td,
                                       constraints=[TimeStepsAllEqualConstraint()])


def td_config() -> dict:
    """Path 6a: the time-dependent family on the card, float64 (the dense
    backend's δ_c floor leaves float32 a KKT floor of a few 1e-6 on it),
    tol = acceptable_tol = 1e-8, 200 iterations, the backend "auto" (which
    falls back to dense, with its warning), one chunk of 2048 lanes: about
    six live (B, 408, 408) float64 tensors, 16 GB. Returns ``{"N",
    "batch", "solve_kw"}``."""
    B = 2048
    return dict(N=51, batch=B, solve_kw=dict(
        phases=((200, None),), chunk=B, tol=1e-8, acceptable_tol=1e-8, backend="auto"))


def td_certificate(res, path: str = GOLDEN_TD):
    """Lanes 0-(L−1) against the JAX package's float64 solve of them
    (``tests/golden/torch/td_order1_n51.npz``, L its lanes): per lane
    |obj/obj* − 1| and max |u − u*|, and the golden's iterations."""
    data = np.load(path)
    L = int(data["lanes"])
    layout = res.problem.trajectory.layout
    N, d = layout.N, layout.dim
    Zg = np.asarray(data["Z"], dtype=np.float64)[:, : N * d].reshape(L, N, d)
    u_star = Zg[..., layout.comp_slice("u")]
    u = res.problem.trajectory.data["u"][:L].detach().to("cpu", torch.float64).numpy()
    obj = res.objective[:L].detach().to("cpu", torch.float64).numpy()
    obj_err = np.abs(obj / np.asarray(data["objective"]) - 1.0)
    return obj_err, np.abs(u - u_star).max(axis=(1, 2)), np.asarray(data["iterations"])


def dense_config() -> dict:
    """Path 6b: lanes 0-255 of path 1's batch on the dense backend, with the
    seek's options (``headline_config()["phase1_kw"]``: Gauss-Newton, tol
    1e-6, mu_init 3e-2, its three phases, 7 trial slots, no SOC and no
    restoration) in one chunk of 256, float32. Returns ``{"N", "lanes",
    "taylor_order", "solve_kw"}``."""
    kw = dict(headline_config()["phase1_kw"], chunk=256, backend="dense")
    return dict(N=51, lanes=256, taylor_order=6, solve_kw=kw)


def cartpole_dense_lbfgs_config() -> dict:
    """Path 6c: lanes 0-1023 of path 5's cartpole batch with
    ``cartpole_lbfgs_config()``'s options (m = 20, tol 1e-4, 300
    iterations) on the dense backend, whose model is the L-BFGS Hessian
    materialized per lane, in one chunk, float32. Returns ``{"N", "lanes",
    "solve_kw"}``."""
    L = 1024
    kw = dict(cartpole_lbfgs_config()["solve_kw"], chunk=L, backend="dense")
    return dict(N=40, lanes=L, solve_kw=kw)
