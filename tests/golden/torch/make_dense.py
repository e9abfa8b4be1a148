"""Make ``dense_e2e.npz``: whole float64 solves of the JAX package's dense
backend that ``tests/test_torch_dense.py`` holds the port's against.

    JAX_PLATFORMS=cpu python tests/golden/torch/make_dense.py

For each end-to-end fixture of ``tests/test_riccati.py`` (``E2E`` in
``tests/torch_twins.py``: ``:357``, ``:407`` and ``:434``) the dense solve at
the test's options: ``Z_<name>``, ``iterations_<name>``,
``objective_<name>``, ``converged_<name>``. And L-BFGS on the dense backend
on the cartpole problem of ``tests/test_lbfgs.py::
test_lbfgs_riccati_matches_dense`` (``make_cartpole_problem(N=30,
seed=0)``, m = 10, tol 1e-5, 300 iterations): ``Z_lbfgs``, ...
"""

import os
import sys
import warnings

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)  # the repo's packages
sys.path.insert(0, os.path.join(ROOT, "tests"))  # the twin fixtures

import directtrajopt_tpu as dtx  # noqa: E402
import torch_twins  # noqa: E402
from directtrajopt_tpu.benchmarks import make_cartpole_problem  # noqa: E402

COMMAND = "JAX_PLATFORMS=cpu python tests/golden/torch/make_dense.py"
LBFGS_KW = dict(tol=1e-5, max_iter=300, hessian_approximation="lbfgs",
                limited_memory_max_history=10)


def _record(out, name, res):
    out.update({f"Z_{name}": np.asarray(res.problem.trajectory.to_zvec()),
                f"iterations_{name}": np.asarray(res.iterations),
                f"objective_{name}": np.asarray(res.objective),
                f"converged_{name}": np.asarray(res.converged)})
    print(f"{name}: iterations {int(res.iterations)}, converged {bool(res.converged)}")


def main() -> None:
    out = {}
    for name, (build, _) in torch_twins.E2E.items():
        prob, _, kw = build()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _record(out, name, dtx.solve(prob, backend="dense", **kw))
    _record(out, "lbfgs", dtx.solve(make_cartpole_problem(N=30, seed=0), backend="dense",
                                    **LBFGS_KW))
    path = os.path.join(HERE, "dense_e2e.npz")
    np.savez(path, command=COMMAND, lbfgs_options=repr(LBFGS_KW), **out)
    print(path)


if __name__ == "__main__":
    main()
