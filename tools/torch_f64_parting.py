"""Where path 7e's float64 solves part: the JAX package's and the port's
iterates, iteration by iteration, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_f64_parting.py [--lane 0] [--tol 1e-10]

Path 7e's lanes 0-3 (the scaling family at state_dim 4, N=51, Padé; seeds
42-45, as ``tests/golden/torch/make_scaled_dim4.py`` builds them) are solved
by both packages in float64 at ``scaled_config()``'s options, phase by phase
as ``solve_batch_compact`` runs them (each phase from the previous phase's
result, μ restarted where the phase says so), through ``solve_batch`` with
rings of every iterate and every telemetry row (``history_size``,
``telemetry_size``). For the lane given, the tool prints each iteration's
gap in Z and in the telemetry columns (objective, inf_pr, inf_du, μ, KKT
error, α, δ_w, θ), and at the first iteration whose Z parts by more than
``--tol`` it reruns both solves up to that iteration and the one before,
and prints the gaps of every part of the IPM state (Z, slacks, duals, μ,
δ_w) there, and both packages' ``print_level=5`` lines up to it (the line
search's branch: SOC, α against α_max, δ_w). With ``--perturb REL`` it
also solves the port against itself, its starting point scaled by
(1 + REL): how far a difference in the last bits of the input grows over
the same iterations.

The whole run takes about two minutes (one JAX compile per phase length).
"""

from __future__ import annotations

import argparse
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests", "golden", "torch"))

from make_scaled import stacked  # noqa: E402

from directtrajopt_tpu.solvers.callbacks import IPMCallbacks as JaxCallbacks  # noqa: E402
from directtrajopt_tpu.solvers.solve import solve_batch as jax_solve_batch  # noqa: E402
from directtrajopt_tpu_torch import benchmarks as tb  # noqa: E402
from directtrajopt_tpu_torch.solvers.callbacks import IPMCallbacks  # noqa: E402
from directtrajopt_tpu_torch.solvers.solve import solve_batch  # noqa: E402

TELEMETRY = ("objective", "inf_pr", "inf_du", "mu", "kkt_error", "alpha", "delta_w", "theta")
STATE = ("Z", "s", "lam", "nu", "zL", "zU", "mu", "delta_w_last", "obj", "err")
LANES, N, STATE_DIM = 4, 51, 4


def options():
    kw = dict(tb.scaled_config()["solve_kw"])
    phases = kw.pop("phases")
    kw.pop("chunk")
    return kw, phases


def phase_kw(kw, p_iter, p_mu):
    out = dict(kw, max_iter=int(p_iter))
    if p_mu is not None:
        out["mu_init"] = p_mu
    return out


def run_jax(prob, kw, rings):
    cb = JaxCallbacks(history_size=rings, telemetry_size=rings) if rings else None
    res = jax_solve_batch(prob, callbacks=cb, **kw)
    jax.block_until_ready(res.iterations)
    return res


def run_port(prob, kw, rings):
    cb = IPMCallbacks(history_size=rings, telemetry_size=rings) if rings else None
    return solve_batch(prob, callbacks=cb, **kw)


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rows(res, lane, n):
    """The lane's first n iterates and telemetry rows (the rings hold every
    iteration: their size is the phase's budget)."""
    return (np_of(res.ipm.history_Z)[lane, :n], np_of(res.ipm.history_stats)[lane, :n])


def state_gaps(rj, rt, lane):
    out = {}
    for name in STATE:
        a, b = getattr(rj.ipm.state, name), getattr(rt.ipm.state, name)
        a, b = np_of(a)[lane], np_of(b)[lane]
        out[name] = float(np.max(np.abs(a - b))) if np.size(a) else 0.0
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lane", type=int, default=0)
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--phases", type=int, default=2, help="phases of scaled_config() to trace")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="also solve the port against itself from Z0·(1 + REL)")
    a = ap.parse_args()
    kw, phases = options()
    jp = stacked(N, STATE_DIM, LANES, None)
    tp = tb.make_batched_scaled_problems(LANES, N, STATE_DIM, device="cpu", dtype=torch.float64)
    pp = None
    if a.perturb:
        pp = tp.replace(trajectory=tp.trajectory.from_zvec(
            tp.trajectory.to_zvec() * (1.0 + a.perturb)))
    done, first = 0, None
    for pi, (p_iter, p_mu) in enumerate(phases[: a.phases]):
        pkw = phase_kw(kw, p_iter, p_mu)
        rj, rt = run_jax(jp, pkw, p_iter), run_port(tp, pkw, p_iter)
        rp = run_port(pp, pkw, p_iter) if pp is not None else None
        n = int(min(np_of(rj.iterations)[a.lane], np_of(rt.iterations)[a.lane]))
        zj, sj = rows(rj, a.lane, n)
        zt, st = rows(rt, a.lane, n)
        if rp is not None:
            n = min(n, int(np_of(rp.iterations)[a.lane]))
            zp = rows(rp, a.lane, n)[0]
        print(f"phase {pi + 1} ({p_iter} iterations, mu_init {p_mu}): lane {a.lane} ran "
              f"{np_of(rj.iterations)[a.lane]} (JAX) / {np_of(rt.iterations)[a.lane]} (port)")
        print("  it  |dZ|max     " + " ".join(f"d{c:<10}" for c in TELEMETRY)
              + ("  |dZ| port/port'" if rp is not None else ""))
        for i in range(n):
            dz = float(np.max(np.abs(zj[i] - zt[i])))
            dt = np.abs(sj[i] - st[i])
            mark = ""
            if first is None and dz > a.tol:
                first, mark = (pi, i, pkw, jp, tp), "  <- first > tol"
            self_gap = f"  {np.max(np.abs(zp[i] - zt[i])):.3e}" if rp is not None else ""
            print(f"  {done + i:3d} {dz:.3e}  " + " ".join(f"{v:.3e}" for v in dt) + self_gap
                  + mark)
            if mark:
                print("      JAX  " + " ".join(f"{c}={v:.17g}" for c, v in zip(TELEMETRY, sj[i])))
                print("      port " + " ".join(f"{c}={v:.17g}" for c, v in zip(TELEMETRY, st[i])))
        done += n
        jp, tp = rj.problem, rt.problem
        pp = rp.problem if rp is not None else None
    if first is None:
        print(f"lane {a.lane}: no iterate parts by more than {a.tol:g}")
        return
    pi, i, pkw, jp0, tp0 = first
    print(f"\nfirst parting: phase {pi + 1}, iteration {i} of the phase; the IPM state "
          f"after {i} and {i + 1} iterations:")
    for k in (i, i + 1):
        if k == 0:
            continue
        g = state_gaps(run_jax(jp0, dict(pkw, max_iter=k), 0),
                       run_port(tp0, dict(pkw, max_iter=k), 0), a.lane)
        print(f"  after {k}: " + " ".join(f"{n}={v:.3e}" for n, v in g.items()))
    # the line search's branch at that step (SOC, accepted α against the
    # fraction-to-boundary α_max, δ_w, ok), both packages' print_level-5
    # lines; the JAX package prints one line a lane, in no fixed lane order
    print(f"\nthe phase's first {i + 1} iterations at print_level 5, JAX package:")
    jax.block_until_ready(jax_solve_batch(jp0, **dict(pkw, max_iter=i + 1, print_level=5)))
    jax.effects_barrier()
    print("the port:")
    solve_batch(tp0, **dict(pkw, max_iter=i + 1, print_level=5))


if __name__ == "__main__":
    main()
