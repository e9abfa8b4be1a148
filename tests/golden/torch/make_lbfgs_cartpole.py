"""Make ``lbfgs_cartpole_n30.npz`` and ``ipm_options_n7.npz``: whole float64
solves of the JAX package that ``tests/test_torch_lbfgs.py`` and
``tests/test_torch_ipm_options.py`` hold the port's against.

    JAX_PLATFORMS=cpu python tests/golden/torch/make_lbfgs_cartpole.py

``lbfgs_cartpole_n30.npz``: the cartpole family at N=30 (lanes from seeds
0-2, ``make_cartpole_problem(N=30, seed=s)`` stacked) solved by
``solve_batch`` on the Riccati backend with L-BFGS at the options of
``tests/test_lbfgs.py::test_lbfgs_riccati_matches_dense`` (m = 10, tol
1e-5, 300 iterations; ``Z``, ``iterations``, ``status``), and the same with
``dual_init="least_squares"`` (``Z_ls``, ``iterations_ls``, ...), the
least-squares initial duals on the identity metric B₀ = I.

``ipm_options_n7.npz``: the N=7 bilinear fixture of
``tests/test_refine.py::test_mu_strategies_f32_under_x64`` (free time,
feasible start; lanes from seeds 0 and 1) in float64 at tol 1e-8, 100
iterations, with each option that changes one rule of the IPM:
``mu_strategy`` "mehrotra" and "adaptive", ``ls_memory=4`` and
``dual_init="least_squares"`` (``Z_<name>``, ``iterations_<name>``, ...,
and the 128-row telemetry ring ``tele_<name>``).
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))  # the repo's packages

import directtrajopt_tpu as dtx  # noqa: E402
from directtrajopt_tpu.benchmarks import make_bilinear_problem, make_cartpole_problem  # noqa: E402

COMMAND = "JAX_PLATFORMS=cpu python tests/golden/torch/make_lbfgs_cartpole.py"
LBFGS_KW = dict(tol=1e-5, max_iter=300, hessian_approximation="lbfgs",
                limited_memory_max_history=10)
CARTPOLE_SEEDS = (0, 1, 2)
OPTION_KW = dict(tol=1e-8, max_iter=100)
OPTIONS = {"mehrotra": dict(mu_strategy="mehrotra"), "adaptive": dict(mu_strategy="adaptive"),
           "ls_memory": dict(ls_memory=4), "least_squares": dict(dual_init="least_squares")}
BILINEAR_SEEDS = (0, 1)
TELE_ROWS = 128


def _stack(probs):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *probs)


def _solve(batch, **kw):
    res = dtx.solve_batch(batch, backend="riccati", **kw)
    out = dict(Z=np.asarray(res.problem.trajectory.to_zvec()),
               iterations=np.asarray(res.iterations), status=np.asarray(res.status),
               converged=np.asarray(res.converged))
    if "callbacks" in kw:
        out["tele"] = np.asarray(res.ipm.history_stats)
    return out


def main() -> None:
    p0 = make_cartpole_problem(N=30, seed=0)
    cart = _stack([p0.replace(trajectory=make_cartpole_problem(N=30, seed=s).trajectory)
                   for s in CARTPOLE_SEEDS])
    out = {}
    for suffix, extra in (("", {}), ("_ls", dict(dual_init="least_squares"))):
        r = _solve(cart, **LBFGS_KW, **extra)
        out.update({k + suffix: v for k, v in r.items()})
        print(f"lbfgs{suffix}: iterations {r['iterations']}, status {r['status']}")
    path = os.path.join(HERE, "lbfgs_cartpole_n30.npz")
    np.savez(path, seeds=np.asarray(CARTPOLE_SEEDS), N=30, options=repr(LBFGS_KW),
             command=COMMAND, **out)
    print(path)

    bil = _stack([make_bilinear_problem(N=7, seed=s, free_time=True, feasible_start=True)
                  for s in BILINEAR_SEEDS])
    out = {}
    for name, extra in OPTIONS.items():
        r = _solve(bil, callbacks=dtx.telemetry(TELE_ROWS), **OPTION_KW, **extra)
        out.update({f"{k}_{name}": v for k, v in r.items()})
        print(f"{name}: iterations {r['iterations']}, status {r['status']}")
    path = os.path.join(HERE, "ipm_options_n7.npz")
    np.savez(path, seeds=np.asarray(BILINEAR_SEEDS), N=7, options=repr(OPTION_KW),
             command=COMMAND, **out)
    print(path)


if __name__ == "__main__":
    main()
