"""The JAX package's float32 solve of path 5's cartpole batch, the
reference for the bars of ``chip_smoke.py``'s path 5a / 5b.

    python tools/torch_cartpole_ref.py [--lanes 8192] [--lbfgs]

Builds the cartpole family of ``directtrajopt_tpu_torch.benchmarks.
make_batched_cartpole_problems`` in the JAX package (lane i from seed i:
``make_cartpole_problem(N=40, seed=i)``'s guess), casts it to float32 and
solves it with ``solve_batch`` on the CPU at ``cartpole_config()``'s
options (exact Hessian, tol 1e-5, 100 iterations) or, with ``--lbfgs``,
``cartpole_lbfgs_config()``'s (m = 20, tol 1e-4, 300 iterations). x64 stays
off: a float32 cartpole does not trace under ``jax_enable_x64`` (the
terminal cost's goal is a float64 closure; ROADMAP Queue 3). Prints the
converged count, the iterations, the worst KKT error and, against
``tests/golden/cartpole_n40_seed0.npz``, the distribution of RMS(u − u*)
and of |obj/obj* − 1| (the float32 objective).
"""

import argparse
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from directtrajopt_tpu.benchmarks import make_cartpole_problem  # noqa: E402
from directtrajopt_tpu.solvers.solve import cast_problem, solve_batch  # noqa: E402
from directtrajopt_tpu_torch.benchmarks import (  # noqa: E402
    cartpole_config,
    cartpole_lbfgs_config,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=8192)
    ap.add_argument("--lbfgs", action="store_true")
    args = ap.parse_args()
    cfg = cartpole_lbfgs_config() if args.lbfgs else cartpole_config()
    kw = {k: v for k, v in cfg["solve_kw"].items() if k not in ("phases", "chunk")}
    kw["max_iter"] = cfg["solve_kw"]["phases"][0][0]
    N, B = cfg["N"], args.lanes
    template = make_cartpole_problem(N=N, seed=0)
    batch = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + jnp.shape(x)), template)
    guesses = [make_cartpole_problem(N=N, seed=s).trajectory.data for s in range(B)]
    data = dict(batch.trajectory.data)
    for name in ("x", "u"):
        data[name] = jnp.asarray(np.stack([np.asarray(g[name]) for g in guesses]))
    batch = cast_problem(batch.replace(trajectory=batch.trajectory.replace(data=data)),
                         jnp.float32)
    t0 = time.perf_counter()
    res = solve_batch(batch, **kw)
    conv, it = np.asarray(res.converged), np.asarray(res.iterations)
    gold = np.load(os.path.join(ROOT, "tests", "golden", "cartpole_n40_seed0.npz"))
    d = template.trajectory.layout.dim
    u_col = template.trajectory.layout.comp_slice("u")
    u_star = gold["Z_star"][: N * d].reshape(N, d)[:, u_col]
    Z = np.asarray(res.problem.trajectory.to_zvec(), dtype=np.float64)[:, : N * d]
    u = Z.reshape(B, N, d)[:, :, u_col]
    rms = np.sqrt(np.mean((u - u_star[None]) ** 2, axis=(1, 2)))[conv]
    obj = np.abs(np.asarray(res.objective, dtype=np.float64) / float(gold["obj"]) - 1.0)[conv]
    kkt = np.asarray(res.kkt_error)[conv]
    print(f"{'L-BFGS' if args.lbfgs else 'exact Hessian'}, {B} lanes, {kw}: "
          f"{time.perf_counter() - t0:.1f} s (compile included)")
    print(f"converged {int(conv.sum())}/{B}; iterations median {np.median(it):g} max {it.max()}")
    print(f"over converged lanes: max kkt {kkt.max():.3e}; RMS(u - u*) median {np.median(rms):.3e} "
          f"max {rms.max():.3e}, {int((rms > 1e-3).sum())} lanes above 1e-3; |obj/obj* - 1| "
          f"median {np.median(obj):.3e} max {obj.max():.3e}")


if __name__ == "__main__":
    main()
