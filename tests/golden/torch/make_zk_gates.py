"""Make ``zk_gates_n11.npz``: the JAX package's exact-Hessian solve of two
N=11 lanes of path 1's family with both z_k gates on
(``DTX_ZK_CUSTOM_HESS``, ``DTX_ZK_READCOLS``), which
``tests/test_torch_zk_gates.py`` holds the port's solve to.

    JAX_PLATFORMS=cpu python tests/golden/torch/make_zk_gates.py

The problems are ``make_batched_bilinear_problems(2, N=11,
feasible_start=True, taylor_order=6)``; the options are the seek's of
``directtrajopt_tpu_torch.benchmarks.headline_config`` with the exact
Hessian, plain inertia regularization and one phase of 60 iterations
(``solve_batch_compact``, chunk 2). Stored: ``Z`` (2, z_dim), the per-lane
``iterations`` and ``converged``, the ``options`` and the ``command`` that
made the file.
"""

import os
import sys

os.environ["DTX_ZK_CUSTOM_HESS"] = "1"
os.environ["DTX_ZK_READCOLS"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))  # the repo's packages

from directtrajopt_tpu.benchmarks import make_batched_bilinear_problems  # noqa: E402
from directtrajopt_tpu.solvers.solve import solve_batch_compact  # noqa: E402
from directtrajopt_tpu_torch.benchmarks import headline_config  # noqa: E402

COMMAND = "JAX_PLATFORMS=cpu python tests/golden/torch/make_zk_gates.py"


def main() -> None:
    kw = {k: v for k, v in headline_config(batch=2)["phase1_kw"].items()
          if k != "hessian_approximation"}
    kw.update(phases=((60, None),), chunk=2, hessian_regularization="inertia")
    res = solve_batch_compact(
        make_batched_bilinear_problems(2, N=11, feasible_start=True, taylor_order=6), **kw)
    out = os.path.join(HERE, "zk_gates_n11.npz")
    np.savez(out, Z=np.asarray(res.problem.trajectory.to_zvec()),
             iterations=np.asarray(res.iterations), converged=np.asarray(res.converged),
             options=repr(kw), command=COMMAND)
    print(f"{out}: iterations {np.asarray(res.iterations).tolist()}, converged "
          f"{np.asarray(res.converged).tolist()}")


if __name__ == "__main__":
    main()
