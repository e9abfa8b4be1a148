"""Make ``scaled.npz``: the JAX package's float64 solves of the scaling
family (``make_scaled_problem``) behind the port's tests and path 7 of
``chip_smoke.py``.

    JAX_PLATFORMS=cpu python tests/golden/torch/make_scaled.py

Stored, each under its prefix:

* ``small_*``: ``make_scaled_problem(N=11, state_dim=8, seed=42)`` through
  ``solve`` at the CPU options of the JAX package's ``bench_sweep.py``
  (tol 1e-8, acceptable_tol 5e-4 after 5 iterations, Gauss-Newton, 378
  iterations): ``Z``, ``iterations``, ``converged``, ``objective``.
* ``p7a_*``, ``p7b_*``, ``p7c_*``: lanes 0-3 (seeds 42-45) of path 7's
  sub-paths at N=51 — 7a state_dim 8 and 7b state_dim 16 with the
  integrator's default method (Padé), 7c state_dim 8 with the Taylor
  action of order 12 — stacked and solved by ``solve_batch_compact`` in
  float64 at path 7's own options (``scaled_config()``, one chunk): per
  lane ``Z``, ``iterations``, ``converged``, ``objective``. These random
  problems are not convex, and a solve stops at its first acceptable
  point (KKT error 5e-4 for 5 iterations), so only a solve that follows
  the same options can be held to them.

Also ``command`` and ``options``. (This directory is not ``tests/golden/``
itself: ``tests/test_golden.py`` solves every ``*.npz`` there.)
"""

import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))  # the repo's packages

from directtrajopt_tpu import (  # noqa: E402
    BilinearIntegrator,
    DerivativeIntegrator,
    DirectTrajOptProblem,
    QuadraticRegularizer,
)
from directtrajopt_tpu.benchmarks import make_scaled_problem  # noqa: E402
from directtrajopt_tpu.solvers.solve import solve, solve_batch_compact  # noqa: E402
from directtrajopt_tpu_torch.benchmarks import scaled_config  # noqa: E402

COMMAND = "JAX_PLATFORMS=cpu python tests/golden/torch/make_scaled.py"
# bench_sweep.py's options off the TPU
OPTIONS = dict(tol=1e-8, acceptable_tol=5e-4, acceptable_iter=5,
               hessian_approximation="gauss_newton", max_iter=378)
# path 7's sub-paths with a golden: (state_dim, Taylor order or None for the default Padé)
SUBPATHS = {"p7a": (8, None), "p7b": (16, None), "p7c": (8, 12)}
GOLDEN_LANES = 4


def scaled_problem(N, state_dim, seed, taylor_order=None):
    """``make_scaled_problem``; with ``taylor_order``, the same problem with
    the Taylor action of that order in place of the default Padé."""
    prob = make_scaled_problem(N=N, state_dim=state_dim, seed=seed)
    if taylor_order is None:
        return prob
    b = prob.integrators[0]
    integ = BilinearIntegrator.create((b.G_drift, list(b.G_drives)), "x", "u",
                                      prob.trajectory, method="taylor",
                                      taylor_order=taylor_order)
    return DirectTrajOptProblem.create(
        prob.trajectory, QuadraticRegularizer.create("u", prob.trajectory, 1.0),
        [integ, DerivativeIntegrator.create("u", "du", prob.trajectory)])


def stacked(N, state_dim, lanes, taylor_order=None):
    probs = [scaled_problem(N, state_dim, 42 + i, taylor_order) for i in range(lanes)]
    return jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *probs)


def record(out, prefix, res):
    out[f"{prefix}_Z"] = np.asarray(res.problem.trajectory.to_zvec())
    out[f"{prefix}_iterations"] = np.asarray(res.iterations)
    out[f"{prefix}_converged"] = np.asarray(res.converged)
    out[f"{prefix}_objective"] = np.asarray(res.objective)
    print(f"{prefix}: converged {out[f'{prefix}_converged']}, iterations "
          f"{out[f'{prefix}_iterations']}, objective {out[f'{prefix}_objective']}", flush=True)


def main() -> None:
    cfg = scaled_config()
    kw = dict(cfg["solve_kw"], chunk=GOLDEN_LANES)
    out = dict(command=COMMAND, options=repr(OPTIONS), path7_options=repr(kw))
    t0 = time.perf_counter()
    record(out, "small", solve(make_scaled_problem(N=11, state_dim=8, seed=42), **OPTIONS))
    for prefix, (dim, order) in SUBPATHS.items():
        record(out, prefix, solve_batch_compact(stacked(cfg["N"], dim, GOLDEN_LANES, order),
                                                **kw))
    path = os.path.join(HERE, "scaled.npz")
    np.savez(path, **out)
    print(f"{path}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
