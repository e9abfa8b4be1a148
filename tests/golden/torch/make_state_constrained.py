"""Make ``state_constrained_n51.npz``: the float64 optimum of lane 0 of the
state-constrained family at N=51, solved by the JAX package.

    JAX_PLATFORMS=cpu python tests/golden/torch/make_state_constrained.py

(This directory is not ``tests/golden/`` itself: ``tests/test_golden.py``
solves every ``*.npz`` there as a bilinear / cartpole golden.)

The problem is ``tests/torch_twins.py::state_constrained(1, 51)``, the same
problem ``directtrajopt_tpu_torch.benchmarks.make_batched_state_constrained_problems``
builds for lane 0 (every lane poses the same optimization problem from a
different start, so this optimum certifies every lane). Stored: the optimum
``Z_star``, the start ``Z0``, ``cap``, ``N``, the solver's ``iterations``,
``status`` and ``kkt_error``, and the ``command`` that made the file.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]  # torch_twins, and the repo's packages

import directtrajopt_tpu as dtx  # noqa: E402
from torch_twins import state_constrained  # noqa: E402

N = 51
COMMAND = "JAX_PLATFORMS=cpu python tests/golden/torch/make_state_constrained.py"


def main() -> None:
    prob, _ = state_constrained(1, N)
    x = np.asarray(prob.trajectory.data["x"])
    cap = float(np.max(np.sum(x**2, axis=1))) + 0.2
    res = dtx.solve(prob, tol=1e-10, acceptable_tol=1e-10, max_iter=300)
    assert bool(res.converged), (int(res.status), float(res.kkt_error))
    out = os.path.join(HERE, "state_constrained_n51.npz")
    np.savez(out, Z_star=np.asarray(res.problem.trajectory.to_zvec()),
             Z0=np.asarray(prob.trajectory.to_zvec()), cap=cap, N=N,
             iterations=int(res.iterations), status=int(res.status),
             kkt_error=float(res.kkt_error), command=COMMAND)
    print(f"{out}: {int(res.iterations)} iterations, status {int(res.status)}, "
          f"kkt {float(res.kkt_error):.3e}, cap {cap:.6f}")


if __name__ == "__main__":
    main()
