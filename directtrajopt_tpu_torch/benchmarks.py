"""Benchmark problems and the certified two-stage pipeline.

Counterpart of the bilinear builders of ``directtrajopt_tpu/benchmarks.py``
(the 4-D Pauli state with 2 bounded drives, a u→du→ddu derivative chain and
a free Δt), plus the accelerator configuration of the benchmark's certified
pipeline — ``headline_config``, ``run_headline`` and ``rms_u_vs_golden`` —
which the tests and ``chip_smoke.py`` take from this one place.

Problems are built on the host in numpy from a seed (the same draws as the
JAX package, so both packages pose the same problems) and put on
``device`` once.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .integrators import BilinearIntegrator, DerivativeIntegrator
from .objectives import QuadraticRegularizer
from .problem import DirectTrajOptProblem
from .trajectory import Trajectory

__all__ = [
    "pauli_generators",
    "make_bilinear_problem",
    "make_batched_bilinear_problems",
    "headline_config",
    "run_headline",
    "rms_u_vs_golden",
    "GOLDEN_N51",
]

GOLDEN_N51 = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden", "bilinear_n51_seed42.npz",
)


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
                                  dtype=dtype, taylor_order=taylor_order),
        DerivativeIntegrator.create("u", "du"),
        DerivativeIntegrator.create("du", "ddu"),
    ]
    obj = QuadraticRegularizer.create("u", traj, 1.0) + QuadraticRegularizer.create("du", traj, 1.0)
    return DirectTrajOptProblem.create(traj, obj, integrators)


def make_bilinear_problem(N: int = 51, seed: int = 42, *, device, dtype=torch.float64,
                          free_time: bool = True, feasible_start: bool = False,
                          taylor_order: int = 12) -> DirectTrajOptProblem:
    """The standard bilinear quantum-gate problem, as one lane."""
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
                             taylor_order=taylor_order)


def make_batched_bilinear_problems(batch: int, N: int = 51, seed: int = 42, *, device,
                                   dtype=torch.float64, free_time: bool = True,
                                   feasible_start: bool = False,
                                   goal_objective: float | None = None,
                                   taylor_order: int = 12) -> DirectTrajOptProblem:
    """A batch of bilinear problems differing in initial controls and state
    data — the same draws as the JAX package's builder of that name."""
    if goal_objective is not None:
        raise NotImplementedError("goal_objective needs TerminalObjective, which is not "
                                  "ported yet (ROADMAP Queue 1 item 10)")
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
                             taylor_order=taylor_order)


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
