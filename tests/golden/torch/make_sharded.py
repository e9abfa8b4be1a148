"""Make ``sharded.npz``: the JAX package's sharded solves that
``tests/test_torch_parallel.py`` holds the port's two gloo ranks to.

    JAX_PLATFORMS=cpu python tests/golden/torch/make_sharded.py

On the 8-device CPU mesh that ``tests/conftest.py`` emulates: (a) the
fixture of ``tests/test_mpc_and_parallel.py::test_sharded_equals_unsharded_n51``
at N=12, B=8 through ``solve_batch_sharded``; (b) the warm, ``carry_duals``
polish of ``test_sharded_compact_warm_carry_equals_unsharded`` (N=8, B=16)
through ``solve_batch_compact_sharded``, after the unsharded seek. The
options are ``tests/_torch_parallel_ranks.py``'s, which the ranks run.
Stored per case: ``<case>_Z`` (B, z_dim), ``<case>_iterations``,
``<case>_converged``; the ``options`` and the ``command`` that made the
file.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [os.path.dirname(TESTS), TESTS]  # the repo's packages; the ranks' options

import _torch_parallel_ranks as ranks  # noqa: E402
from directtrajopt_tpu.benchmarks import make_batched_bilinear_problems  # noqa: E402
from directtrajopt_tpu.parallel import (  # noqa: E402
    make_mesh,
    solve_batch_compact_sharded,
    solve_batch_sharded,
)
from directtrajopt_tpu.solvers.solve import solve_batch_compact  # noqa: E402

COMMAND = "JAX_PLATFORMS=cpu python tests/golden/torch/make_sharded.py"


def main() -> None:
    assert len(jax.devices()) == 8, jax.devices()
    mesh = make_mesh(jax.devices()[:8])
    a = solve_batch_sharded(make_batched_bilinear_problems(8, N=12, feasible_start=True),
                            mesh=mesh, **ranks.SHARDED_KW)
    seek = solve_batch_compact(make_batched_bilinear_problems(16, N=8, feasible_start=True),
                               **ranks.SEEK_KW)
    b = solve_batch_compact_sharded(seek.problem, mesh=mesh, warm=seek.ipm.state.best_kkt_warm,
                                    **ranks.POLISH_KW)
    out = {}
    for case, r in (("a", a), ("b", b)):
        out.update({f"{case}_Z": np.asarray(jax.device_get(r.ipm.Z)),
                    f"{case}_iterations": np.asarray(r.iterations),
                    f"{case}_converged": np.asarray(r.converged)})
        print(f"({case}) iterations {out[case + '_iterations'].tolist()}, "
              f"converged {int(out[case + '_converged'].sum())}/{len(out[case + '_converged'])}")
    path = os.path.join(HERE, "sharded.npz")
    np.savez(path, **out, options=repr((ranks.SHARDED_KW, ranks.SEEK_KW, ranks.POLISH_KW)),
             command=COMMAND)
    print(path)


if __name__ == "__main__":
    main()
