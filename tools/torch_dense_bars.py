"""The JAX package's converged share behind path 6b's bar in ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python tools/torch_dense_bars.py [--lanes 64]

Path 6b runs lanes 0-255 of path 1's batch (``make_batched_bilinear_problems(
8192, N=51, feasible_start=True, taylor_order=6)``, float32) through
``solve_batch_compact`` on the dense backend with the seek's options
(``dense_config()``). This script runs the JAX package's float32 dense solve
of the first ``--lanes`` of those lanes (CPU) at the same options and prints
the converged count, the median and maximum iterations, whether every
iterate is finite, and the seconds (compile included). Path 6b's bar is the
converged share less 0.1.
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
from directtrajopt_tpu_torch.benchmarks import dense_config, headline_config  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=64)
    args = ap.parse_args()
    cfg, hl = dense_config(), headline_config()
    full = make_batched_bilinear_problems(hl["batch"], N=cfg["N"], feasible_start=True,
                                          taylor_order=cfg["taylor_order"])
    prob = cast_problem(jax.tree.map(lambda x: x[: args.lanes], full), jnp.float32)
    kw = dict(cfg["solve_kw"], chunk=min(cfg["solve_kw"]["chunk"], args.lanes))
    t0 = time.perf_counter()
    res = solve_batch_compact(prob, **kw)
    conv, it = np.asarray(res.converged), np.asarray(res.iterations)
    kkt = np.asarray(res.kkt_error)
    fin = bool(np.isfinite(np.asarray(res.problem.trajectory.to_zvec())).all())
    print(f"dense seek: converged {int(conv.sum())}/{args.lanes} ({conv.mean():.4f}), iterations "
          f"median {np.median(it):g} max {it.max()}, max kkt over converged "
          f"{kkt[conv].max() if conv.any() else float('nan'):.3e}, finite {fin}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
