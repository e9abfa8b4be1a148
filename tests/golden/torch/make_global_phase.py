"""Make ``global_phase_n51.npz``: the float64 optimum of lane 0 of the
global-phase family at N=51, and the solutions of its first 64 lanes at the
card's own options, both solved by the JAX package.

    JAX_PLATFORMS=cpu python tests/golden/torch/make_global_phase.py

(This directory is not ``tests/golden/`` itself: ``tests/test_golden.py``
solves every ``*.npz`` there as a bilinear / cartpole golden.)

The problem is ``tests/torch_twins.py::global_phase(1, 51)``, the same
problem ``directtrajopt_tpu_torch.benchmarks.make_batched_global_problems``
builds for lane 0 (every lane poses the same optimization problem from a
different start, so this optimum certifies every lane). Stored: the optimum
``Z_star`` (the N knots, then θ), the start ``Z0``, ``N``, the solver's
``iterations``, ``status`` and ``kkt_error``, and the ``command`` that made
the file.

At the card's tolerance (1e-6) u is weakly determined: a solve stops up to
6e-3 from the optimum's u, the same point in float32 and float64 and in both
packages. So the file also holds ``Z_ref`` (64, z_dim): lanes 0-63 of the
family (seeds 0-63) solved in float64 with the options of
``directtrajopt_tpu_torch.benchmarks.global_config`` (recorded in
``ref_options``), the reference for a float32 solve of the same lanes.
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
from directtrajopt_tpu.solvers.solve import solve_batch_compact  # noqa: E402
from directtrajopt_tpu_torch.benchmarks import global_config  # noqa: E402
from torch_twins import global_phase  # noqa: E402

N = 51
N_REF = 64
COMMAND = "JAX_PLATFORMS=cpu python tests/golden/torch/make_global_phase.py"


def main() -> None:
    prob, _ = global_phase(1, N)
    res = dtx.solve(prob, tol=1e-10, acceptable_tol=1e-10, max_iter=300)
    assert bool(res.converged), (int(res.status), float(res.kkt_error))
    kw = dict(global_config()["solve_kw"], chunk=N_REF)
    ref = solve_batch_compact(global_phase(N_REF, N)[0], **kw)
    assert bool(np.asarray(ref.converged).all()), np.asarray(ref.status)
    out = os.path.join(HERE, "global_phase_n51.npz")
    np.savez(out, Z_star=np.asarray(res.problem.trajectory.to_zvec()),
             Z0=np.asarray(prob.trajectory.to_zvec()), N=N,
             iterations=int(res.iterations), status=int(res.status),
             kkt_error=float(res.kkt_error), command=COMMAND,
             Z_ref=np.asarray(ref.problem.trajectory.to_zvec()), ref_options=repr(kw))
    print(f"{out}: {int(res.iterations)} iterations, status {int(res.status)}, "
          f"kkt {float(res.kkt_error):.3e}, theta {np.asarray(res.problem.trajectory.to_zvec())[-2:]}; "
          f"reference lanes 0-{N_REF - 1}: {np.asarray(ref.iterations).min()}-"
          f"{np.asarray(ref.iterations).max()} iterations")


if __name__ == "__main__":
    main()
