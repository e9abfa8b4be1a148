"""Make ``scheduled_n51.npz``: the JAX package's float64
``solve_batch_scheduled`` of lanes 0-63 of the N=51 bilinear family at the
options of path 4a on the card.

    JAX_PLATFORMS=cpu python tests/golden/torch/make_scheduled.py

(This directory is not ``tests/golden/`` itself: ``tests/test_golden.py``
solves every ``*.npz`` there as a bilinear / cartpole golden.)

The problems are lanes 0-63 of ``make_batched_bilinear_problems(8192, N=51,
feasible_start=True, taylor_order=6)`` (that function draws the du and ddu
guesses of all lanes after their controls, so lanes 0-63 of a 64-lane
batch would be other problems), the lanes that
``directtrajopt_tpu_torch.benchmarks.scheduled_config`` runs on the card.
A lane's result in a lockstep or scheduled batch does not depend on the
other lanes, so these 64 solves are the card's. Stored: ``Z_ref`` (64,
z_dim), the per-lane ``iterations`` and ``status``, ``N``, ``lanes``, the
``options`` and the ``command`` that made the file.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))  # the repo's packages

from directtrajopt_tpu.benchmarks import make_batched_bilinear_problems  # noqa: E402
from directtrajopt_tpu.solvers.solve import solve_batch_scheduled  # noqa: E402
from directtrajopt_tpu_torch.benchmarks import scheduled_config  # noqa: E402

N_REF = 64
COMMAND = "JAX_PLATFORMS=cpu python tests/golden/torch/make_scheduled.py"


def main() -> None:
    cfg = scheduled_config()
    full = make_batched_bilinear_problems(cfg["batch"], N=cfg["N"], feasible_start=True,
                                          taylor_order=cfg["taylor_order"])
    prob = jax.tree.map(lambda x: x[:N_REF], full)
    kw = {k: v for k, v in cfg["solve_kw"].items() if k != "callbacks"}
    res = solve_batch_scheduled(prob, **kw)
    conv = np.asarray(res.converged)
    assert conv.all(), np.asarray(res.status)
    out = os.path.join(HERE, "scheduled_n51.npz")
    it = np.asarray(res.iterations)
    np.savez(out, Z_ref=np.asarray(res.problem.trajectory.to_zvec()), iterations=it,
             status=np.asarray(res.status), N=cfg["N"], lanes=N_REF, options=repr(kw),
             command=COMMAND)
    print(f"{out}: {conv.sum()}/{N_REF} converged, iterations {it.min()}-{it.max()} "
          f"(median {np.median(it):g}), {int((it > kw['phase1_iter']).sum())} stragglers")


if __name__ == "__main__":
    main()
