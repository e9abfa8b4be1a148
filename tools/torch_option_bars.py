"""The JAX package's converged counts behind path 5c's bars in ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python tools/torch_option_bars.py [--lanes 64]

Path 5c runs lanes 0-255 of path 1's batch (``make_batched_bilinear_problems(
8192, N=51, feasible_start=True, taylor_order=6)``, float32) through
``solve_batch_compact`` with the seek's options (``headline_config()
["phase1_kw"]``), five times, each time with one option changed. This script
runs the JAX package's float32 solve of the first ``--lanes`` of those lanes
(CPU, x64 enabled, which ``refine_residuals`` needs) at the same options,
with no option changed and then with each of the five, and prints per run
the converged count, the median and maximum iterations, and the seconds
(compile included).
"""

import argparse
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from directtrajopt_tpu.benchmarks import make_batched_bilinear_problems  # noqa: E402
from directtrajopt_tpu.solvers.solve import cast_problem, solve_batch_compact  # noqa: E402
from directtrajopt_tpu_torch.benchmarks import headline_config  # noqa: E402

VARIANTS = {
    "seek": {},
    "mehrotra": dict(mu_strategy="mehrotra"),
    "adaptive": dict(mu_strategy="adaptive"),
    "ls_memory=4": dict(ls_memory=4),
    "least_squares": dict(dual_init="least_squares"),
    "refine_residuals": dict(refine_residuals=True, compensated_residuals=False),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=64)
    args = ap.parse_args()
    cfg = headline_config()
    full = make_batched_bilinear_problems(cfg["batch"], N=cfg["N"], feasible_start=True,
                                          taylor_order=cfg["taylor_order"])
    prob = cast_problem(jax.tree.map(lambda x: x[: args.lanes], full), jnp.float32)
    for name, extra in VARIANTS.items():
        kw = dict(cfg["phase1_kw"], chunk=min(cfg["phase1_kw"]["chunk"], args.lanes), **extra)
        t0 = time.perf_counter()
        res = solve_batch_compact(prob, **kw)
        conv, it = np.asarray(res.converged), np.asarray(res.iterations)
        fin = bool(np.isfinite(np.asarray(res.problem.trajectory.to_zvec())).all())
        print(f"{name}: converged {int(conv.sum())}/{args.lanes}, iterations median "
              f"{np.median(it):g} max {it.max()}, finite {fin}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
