"""Make ``scaled_dim4.npz``: the JAX package's float64 solve of the scaling
family at state_dim 4 behind path 7e of ``chip_smoke.py`` and the port's
tests.

    JAX_PLATFORMS=cpu python tests/golden/torch/make_scaled_dim4.py

Stored under ``p7e_*``: lanes 0-3 (seeds 42-45) of path 7e, N=51,
state_dim 4 with the integrator's default method (Padé), stacked and solved
by ``solve_batch_compact`` in float64 at path 7's own options
(``scaled_config()``, one chunk): per lane ``Z``, ``iterations``,
``converged``, ``objective``, as ``make_scaled.py`` stores ``p7a_*``.
Under ``p7e_short_*`` the same for the solve cut after the options' first
two phases (20 + 30 iterations): the port's CPU test holds its float64
solve to it. The whole solve is not fit for that: these random problems
are not convex, and lane 0's iterates, 4.4e-9 from the port's float64
iterates after 50 iterations, end 2.06 apart after 122, on equal
iterations. Also ``command`` and ``path7_options``.
"""

import os
import time

import numpy as np

from make_scaled import GOLDEN_LANES, HERE, record, scaled_config, solve_batch_compact, stacked

COMMAND = "JAX_PLATFORMS=cpu python tests/golden/torch/make_scaled_dim4.py"
# path 7e: (state_dim, Taylor order or None for the default Padé)
SUBPATHS = {"p7e": (4, None)}
SHORT_PHASES = 2


def main() -> None:
    cfg = scaled_config()
    kw = dict(cfg["solve_kw"], chunk=GOLDEN_LANES)
    out = dict(command=COMMAND, path7_options=repr(kw))
    t0 = time.perf_counter()
    for prefix, (dim, order) in SUBPATHS.items():
        prob = stacked(cfg["N"], dim, GOLDEN_LANES, order)
        record(out, prefix, solve_batch_compact(prob, **kw))
        record(out, f"{prefix}_short",
               solve_batch_compact(prob, **dict(kw, phases=kw["phases"][:SHORT_PHASES])))
    path = os.path.join(HERE, "scaled_dim4.npz")
    np.savez(path, **out)
    print(f"{path}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
