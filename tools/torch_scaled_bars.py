"""The JAX package's float32 solves behind path 7's bars in ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python tools/torch_scaled_bars.py [--lanes 64] [--only 7e]
        [--port | --witness-7d]

Path 7 solves the scaling family (``make_scaled_problem`` at N=51, lane i
from seed 42 + i) in float32 through ``solve_batch_compact`` with
``scaled_config()``: 7a state_dim 8, 7b state_dim 16 and 7e state_dim 4
with the default Padé method, 7c state_dim 8 with the Taylor action of
order 12. For each (``--only``: the sub-paths named), this script runs the
JAX package's float32 solve of lanes 0-(``--lanes`` − 1) on the CPU at the
same options and prints the converged count (the bar is that share less
0.1), the iterations, and, on the lanes of the float64 golden
(``tests/golden/torch/scaled.npz``, ``make_scaled.py``; 7e's
``scaled_dim4.npz``, ``make_scaled_dim4.py``) where both converge, max
|obj/obj* − 1| (the card's bar on the same lanes).

``--port`` also solves the golden's lanes with the port on the CPU in
float64 at the golden's options (path 7's, one chunk) and prints its
iterations beside the golden's, lane by lane.

``--witness-7d`` instead solves path 7d's problems (lanes 0-(``--lanes`` − 1)
at N=11, state_dim 23, Taylor order 12, beyond every kernel's caps) in
float32 on the CPU twice, with the JAX package and with the port, at 7d's options
(path 7's, one chunk), and prints how far the two sound float32 solves
part: iterations equal lane by lane, the converged counts, and per lane
max |Z_jax − Z_port| / max(max |Z_port|, 1), on the lanes of equal
iterations and on the others, for the first 5 iterations and the whole
solve. ``chip_smoke.py`` holds the card's 7d solve against the port's CPU
solve by the same measure.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests", "golden", "torch"))

from directtrajopt_tpu.solvers.solve import cast_problem, solve_batch_compact  # noqa: E402
from directtrajopt_tpu_torch.benchmarks import (  # noqa: E402
    GOLDEN_SCALED,
    GOLDEN_SCALED_DIM4,
    scaled_config,
)
from make_scaled import SUBPATHS, stacked  # noqa: E402
from make_scaled_dim4 import SUBPATHS as SUBPATHS_DIM4  # noqa: E402

from chip_smoke import ITER_7D, LANES_7D, N_7D, STATE_7D, Z_7D, scaled_batch  # noqa: E402


def port_iterations(dim, order, lanes, kw):
    """The port's float64 CPU solve of the golden's lanes: iterations."""
    import torch

    from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact as port_compact

    torch.set_num_threads(4)
    prob = scaled_batch(lanes, 51, dim, taylor_order=order, dev="cpu", dtype=torch.float64)
    res = port_compact(prob, **dict(kw, chunk=lanes))
    return res.iterations.numpy(), res.converged.numpy()


def witness_7d(cfg, lanes) -> None:
    """The JAX package's and the port's float32 CPU solves of 7d's problems
    (lanes 0-(lanes − 1), in chunks of 7d's batch)."""
    import torch

    from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact as port_compact

    torch.set_num_threads(4)
    kw = dict(cfg["solve_kw"], chunk=LANES_7D)
    short = dict(kw, phases=((ITER_7D, None),))
    jprob = cast_problem(stacked(N_7D, STATE_7D, lanes, 12), jnp.float32)
    pprob = scaled_batch(lanes, N_7D, STATE_7D, taylor_order=12, dev="cpu")
    for what, opts in ((f"first {ITER_7D} iterations", short), ("whole solve", kw)):
        t0 = time.perf_counter()
        j = solve_batch_compact(jprob, **opts)
        t1 = time.perf_counter()
        p = port_compact(pprob, **opts)
        t2 = time.perf_counter()
        zj = np.asarray(j.problem.trajectory.to_zvec(), dtype=np.float64)
        zp = p.problem.trajectory.to_zvec().double().numpy()
        dz = np.abs(zj - zp).max(1) / np.maximum(np.abs(zp).max(1), 1.0)
        it_j, it_p = np.asarray(j.iterations), p.iterations.numpy()
        same = it_j == it_p
        part = dz[~same]
        far = np.flatnonzero(same & (dz > Z_7D))
        print(f"7d {what}: JAX {t1 - t0:.1f} s, port {t2 - t1:.1f} s; converged JAX "
              f"{int(np.asarray(j.converged).sum())} port {int(p.converged.sum())} of "
              f"{lanes}; iterations equal on {int(same.sum())} lanes (JAX median "
              f"{np.median(it_j):g} max {it_j.max()}, port median {np.median(it_p):g} max "
              f"{it_p.max()}); per-lane |Z_jax - Z_port| on those: median "
              f"{np.median(dz[same]):.3e} max {dz[same].max():.3e}, beyond {Z_7D:g} on lanes "
              f"{far.tolist()} ({dz[far].tolist()}); on the others: max "
              f"{part.max() if part.size else float('nan'):.3e}; lanes parted (other "
              f"iterations or Z beyond {Z_7D:g}): {int((~same).sum()) + far.size}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--witness-7d", action="store_true")
    ap.add_argument("--only", nargs="+", metavar="TAG", help="sub-paths (7a, 7b, 7c, 7e)")
    args = ap.parse_args()
    cfg = scaled_config()
    if args.witness_7d:
        witness_7d(cfg, args.lanes)
        return
    kw = dict(cfg["solve_kw"], chunk=min(cfg["solve_kw"]["chunk"], args.lanes))
    goldens = [(p, sub, GOLDEN_SCALED) for p, sub in SUBPATHS.items()]
    goldens += [(p, sub, GOLDEN_SCALED_DIM4) for p, sub in SUBPATHS_DIM4.items()]
    for prefix, (dim, order), path in goldens:
        if args.only and prefix[1:] not in args.only:
            continue
        gold = np.load(path)
        t0 = time.perf_counter()
        prob = cast_problem(stacked(cfg["N"], dim, args.lanes, order), jnp.float32)
        res = solve_batch_compact(prob, **kw)
        conv, it = np.asarray(res.converged), np.asarray(res.iterations)
        obj = np.asarray(res.objective, dtype=np.float64)
        g_conv, g_obj = gold[f"{prefix}_converged"], gold[f"{prefix}_objective"]
        n = len(g_obj)
        both = conv[:n] & g_conv
        err = np.abs(obj[:n] / g_obj - 1.0)
        worst = float(err[both].max()) if both.any() else float("nan")
        print(f"{prefix} (state_dim {dim}, {'Padé' if order is None else f'Taylor {order}'}): "
              f"JAX float32 converged {int(conv.sum())}/{args.lanes} ({conv.mean():.4f}); "
              f"iterations median {np.median(it):g} max {it.max()}; golden lanes 0-{n - 1}: "
              f"both converged on {int(both.sum())}, |obj/obj* - 1| {err.tolist()} (max over "
              f"both {worst:.3e}); {time.perf_counter() - t0:.1f} s", flush=True)
        if args.port:
            p_it, p_conv = port_iterations(dim, order, n, kw)
            print(f"{prefix}: port float64 iterations {p_it.tolist()} (converged "
                  f"{p_conv.tolist()}), golden {gold[f'{prefix}_iterations'].tolist()} "
                  f"(converged {g_conv.tolist()})", flush=True)


if __name__ == "__main__":
    main()
