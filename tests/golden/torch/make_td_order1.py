"""Make ``td_order1_n51.npz`` and ``td_lowering_n10.npz``: whole float64
solves of the JAX package that ``chip_smoke.py`` (path 6a) and
``tests/test_torch_time_dependent.py`` hold the port's against.

    JAX_PLATFORMS=cpu python tests/golden/torch/make_td_order1.py

``td_order1_n51.npz``: lanes 0-15 of path 6a's family
(``directtrajopt_tpu_torch.benchmarks.make_batched_td_problems``: the same
host data from ``td_data``, built here in the JAX package with its
``TimeDependentBilinearIntegrator``), solved by ``solve_batch`` at
``td_config()``'s options (tol = acceptable_tol = 1e-8, 200 iterations,
backend "auto", which falls back to dense): ``Z``, ``objective``,
``iterations``, ``kkt``, ``converged``, ``td_error``.

``td_lowering_n10.npz``: the order-1 problem with a u→du chain of
``tests/test_time_dependent.py::test_td_order1_riccati_via_substitution``
(N=10), solved at its options (tol 1e-10, 200 iterations) on the Riccati
backend (through the lowering) and on the dense backend: ``Z_<backend>``,
``objective_<backend>``, ``iterations_<backend>``.
"""

import os
import sys
import warnings

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))  # the repo's packages

import directtrajopt_tpu as dtx  # noqa: E402
from directtrajopt_tpu_torch import benchmarks as tb  # noqa: E402

COMMAND = "JAX_PLATFORMS=cpu python tests/golden/torch/make_td_order1.py"
LANES = 16
G_DRIFT = np.array([[0.0, 1.0], [-1.0, 0.0]])
G_DRIVE = np.array([[0.0, 1.0], [1.0, 0.0]])


def td_generator_jax():
    """``benchmarks.td_generator`` in the JAX package: the same operations in
    the same order, in u's dtype."""
    Gx, Gy, Gz = tb.pauli_generators()

    def G(u, t):
        return ((1.0 + tb.TD_AMP * jnp.sin(t)) * jnp.asarray(tb.TD_OMEGA * Gz, dtype=u.dtype)
                + u[0] * jnp.asarray(Gx, dtype=u.dtype) + u[1] * jnp.asarray(Gy, dtype=u.dtype))

    return G


def td_family(lanes: int, N: int = 51):
    """Path 6a's family as a batched JAX problem."""
    d = tb.td_data(lanes, N)
    G = td_generator_jax()
    probs = []
    for i in range(lanes):
        traj = dtx.Trajectory.create(
            {"x": d["x"][i], "u": d["u"][i], "t": d["t"][i], "dt": d["dt"][i]}, timestep="dt",
            controls=("u",), initial={"x": [1.0, 0.0, 0.0, 0.0], "t": [0.0]},
            final={"x": d["x_final"][i]}, bounds={"u": 0.5, "dt": (0.05, 0.2)})
        td = dtx.TimeDependentBilinearIntegrator.create(G, "x", "u", "t", traj, spline_order=1,
                                                        n_steps=tb.TD_N_STEPS)
        probs.append(dtx.DirectTrajOptProblem.create(
            traj, dtx.QuadraticRegularizer.create("u", traj, 1.0), td,
            constraints=[dtx.TimeStepsAllEqualConstraint()]))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *probs)


def lowering_problem():
    """``test_td_order1_riccati_via_substitution``'s problem (N=10)."""
    N = 10
    rng = np.random.default_rng(3)
    dts = np.full((N, 1), 0.1)
    traj = dtx.Trajectory.create(
        {"x": rng.normal(size=(N, 2)) * 0.5, "u": rng.normal(size=(N, 1)) * 0.3,
         "du": rng.normal(size=(N, 1)) * 0.1, "t": np.cumsum(dts, axis=0) - 0.1, "dt": dts},
        timestep="dt", controls="du", initial={"x": [1.0, 0.0], "t": [0.0]},
        bounds={"dt": (0.05, 0.2)})

    def G(u, t):
        return (1.0 + 0.2 * jnp.sin(t)) * jnp.asarray(G_DRIFT) + u[0] * jnp.asarray(G_DRIVE)

    td = dtx.TimeDependentBilinearIntegrator.create(G, "x", "u", "t", traj, spline_order=1,
                                                    n_steps=6)
    chain = dtx.DerivativeIntegrator.create("u", "du", traj)
    obj = (dtx.QuadraticRegularizer.create("u", traj, 1.0)
           + dtx.QuadraticRegularizer.create("du", traj, 0.1))
    return dtx.DirectTrajOptProblem.create(traj, obj, [td, chain],
                                           constraints=[dtx.TimeConsistencyConstraint(
                                               time_name="t")])


def main() -> None:
    kw = {k: v for k, v in tb.td_config()["solve_kw"].items() if k not in ("phases", "chunk")}
    kw["max_iter"] = tb.td_config()["solve_kw"]["phases"][0][0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = dtx.solve_batch(td_family(LANES), **kw)
    path = os.path.join(HERE, "td_order1_n51.npz")
    np.savez(path, lanes=LANES, N=51, options=repr(kw), command=COMMAND,
             Z=np.asarray(res.problem.trajectory.to_zvec()),
             objective=np.asarray(res.objective), iterations=np.asarray(res.iterations),
             kkt=np.asarray(res.kkt_error), converged=np.asarray(res.converged),
             td_error=np.asarray(res.td_error))
    print(f"td order 1: iterations {np.asarray(res.iterations)}, converged "
          f"{int(np.asarray(res.converged).sum())}/{LANES}")
    print(path)

    prob = lowering_problem()
    out = {}
    for backend in ("riccati", "dense"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = dtx.solve(prob, backend=backend, tol=1e-10, max_iter=200)
        out.update({f"Z_{backend}": np.asarray(r.problem.trajectory.to_zvec()),
                    f"objective_{backend}": np.asarray(r.objective),
                    f"iterations_{backend}": np.asarray(r.iterations)})
        print(f"lowering {backend}: iterations {int(r.iterations)}")
    path = os.path.join(HERE, "td_lowering_n10.npz")
    np.savez(path, command=COMMAND, **out)
    print(path)


if __name__ == "__main__":
    main()
