"""The JAX package's converged share behind path 6b's bar in ``chip_smoke.py``,
and where the port's float32 dense solve parts between the CPU and the card.

    JAX_PLATFORMS=cpu python tools/torch_dense_bars.py [--lanes 64] [--port]
    python3 tools/torch_dense_bars.py --witness [--lanes 64]     # on one GPU

Path 6b runs lanes 0-255 of path 1's batch (``make_batched_bilinear_problems(
8192, N=51, feasible_start=True, taylor_order=6)``, float32) through
``solve_batch_compact`` on the dense backend with the seek's options
(``dense_config()``). This script runs the JAX package's float32 dense solve
of the first ``--lanes`` of those lanes (CPU) at the same options and prints
the converged count, the median and maximum iterations, whether every
iterate is finite, the seconds (compile included) and the lanes that
converged. Path 6b's bar is the converged share less 0.1. ``--port`` runs
the port's float32 dense solve of the same lanes on the CPU instead (the
lanes taken from the port's 8192-lane builder with ``tree_take``).

``--witness`` (the port only; needs the card) runs the port's dense seek of
the same lanes in six variants of one code: float32 on the CPU; float32 on
the card; float32 on the card with every kernel call routed to its plain
version (``_build.route`` replaced); float32 on the card with the dense
backend's Cholesky factorization and solves (``torch.linalg.cholesky_ex``,
``torch.cholesky_solve``) done on the CPU; float32 on the CPU with them done
on the card; float64 on the card. For each it prints the seek's result as
above. Then it traces the seek's first phase (20 iterations) of each variant
with an ``IPMCallbacks.host_fn`` and prints, beside the CPU's float32 trace,
the first iteration at which each lane's objective differs by more than
1e-6 relative or its KKT error by more than a factor of 2, and per
iteration the median over the lanes of both differences.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from directtrajopt_tpu_torch.benchmarks import dense_config, headline_config  # noqa: E402

TRACE_ITERS = 20  # the seek's first phase


def report(name, lanes, seconds, Z, conv, it, kkt) -> None:
    fin = bool(np.isfinite(Z).all())
    print(f"{name} dense seek: converged {int(conv.sum())}/{lanes} ({conv.mean():.4f}), iterations "
          f"median {np.median(it):g} max {it.max()}, max kkt over converged "
          f"{kkt[conv].max() if conv.any() else float('nan'):.3e}, finite {fin}, "
          f"{seconds:.1f} s; converged lanes {np.flatnonzero(conv).tolist()}; "
          f"iterations {it.tolist()}", flush=True)


def jax_seek(lanes: int, kw: dict) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from directtrajopt_tpu.benchmarks import make_batched_bilinear_problems
    from directtrajopt_tpu.solvers.solve import cast_problem, solve_batch_compact

    cfg, hl = dense_config(), headline_config()
    full = make_batched_bilinear_problems(hl["batch"], N=cfg["N"], feasible_start=True,
                                          taylor_order=cfg["taylor_order"])
    prob = cast_problem(jax.tree.map(lambda x: x[:lanes], full), jnp.float32)
    t0 = time.perf_counter()
    res = solve_batch_compact(prob, **kw)
    report("JAX package", lanes, time.perf_counter() - t0,
           np.asarray(res.problem.trajectory.to_zvec()), np.asarray(res.converged),
           np.asarray(res.iterations), np.asarray(res.kkt_error))


def port_problem(lanes: int, device: str, dtype):
    """Lanes 0..lanes-1 of path 1's 8192-lane batch, on ``device`` in ``dtype``."""
    import torch

    from directtrajopt_tpu_torch import benchmarks as tb
    from directtrajopt_tpu_torch.module import tree_take
    from directtrajopt_tpu_torch.solvers.solve import cast_problem

    cfg, hl = dense_config(), headline_config()
    full = tb.make_batched_bilinear_problems(hl["batch"], N=cfg["N"], feasible_start=True,
                                             taylor_order=cfg["taylor_order"], device=device)
    return cast_problem(tree_take(full, torch.arange(lanes, device=device)), dtype)


def port_seek(name: str, lanes: int, kw: dict, device: str, dtype) -> None:
    import torch

    from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact

    prob = port_problem(lanes, device, dtype)
    t0 = time.perf_counter()
    res = solve_batch_compact(prob, **kw)
    if device != "cpu":
        torch.cuda.synchronize()
    report(name, lanes, time.perf_counter() - t0,
           res.problem.trajectory.to_zvec().cpu().numpy(), res.converged.cpu().numpy(),
           res.iterations.cpu().numpy(), res.kkt_error.cpu().numpy())


def port_trace(lanes: int, kw: dict, device: str, dtype) -> dict:
    """Per-iteration (T, lanes) objective and KKT error of the seek's first
    phase (``solve_batch``, ``TRACE_ITERS`` iterations)."""
    from directtrajopt_tpu_torch.solvers.callbacks import IPMCallbacks
    from directtrajopt_tpu_torch.solvers.solve import solve_batch

    opts = {k: v for k, v in kw.items() if k not in ("phases", "chunk")}
    rows = {"objective": [], "kkt_error": []}

    def host_fn(info):
        for k in rows:
            rows[k].append(info[k].double().cpu().numpy())

    solve_batch(port_problem(lanes, device, dtype), callbacks=IPMCallbacks(host_fn=host_fn),
                max_iter=TRACE_ITERS, **opts)
    return {k: np.stack(v) for k, v in rows.items()}


class Variant:
    """A context that sends kernel calls to their plain versions (``plain``)
    and/or runs the dense Cholesky factorization and solves on ``chol_on``."""

    def __init__(self, plain: bool = False, chol_on: str | None = None):
        self.plain, self.chol_on = plain, chol_on

    def __enter__(self):
        import torch

        from directtrajopt_tpu_torch.ops import _build

        self.saved = (_build.route, torch.linalg.cholesky_ex, torch.cholesky_solve)
        route, chol, solve = self.saved
        if self.plain:
            _build.route = lambda *a, **k: "plain"
        if self.chol_on is not None:
            on = self.chol_on

            def chol_ex(M, *a, **k):
                L, info = chol(M.to(on), *a, **k)
                return L.to(M.device), info.to(M.device)

            def chol_solve(r, L, *a, **k):
                return solve(r.to(on), L.to(on), *a, **k).to(r.device)

            torch.linalg.cholesky_ex, torch.cholesky_solve = chol_ex, chol_solve
        return self

    def __exit__(self, *exc):
        import torch

        from directtrajopt_tpu_torch.ops import _build

        _build.route, torch.linalg.cholesky_ex, torch.cholesky_solve = self.saved


def witness(lanes: int, kw: dict) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: --witness compares the CPU with the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    f32, f64 = torch.float32, torch.float64
    variants = [
        ("cpu f32", "cpu", f32, Variant()),
        ("card f32", "cuda", f32, Variant()),
        ("card f32, kernels off", "cuda", f32, Variant(plain=True)),
        ("card f32, Cholesky on the CPU", "cuda", f32, Variant(chol_on="cpu")),
        ("cpu f32, Cholesky on the card", "cpu", f32, Variant(chol_on="cuda")),
        ("card f64", "cuda", f64, Variant()),
    ]
    traces = {}
    for name, device, dtype, ctx in variants:
        with ctx:
            port_seek(name, lanes, kw, device, dtype)
            traces[name] = port_trace(lanes, kw, device, dtype)
    ref = traces["cpu f32"]
    for name, tr in traces.items():
        if name == "cpu f32":
            continue
        T = min(len(tr["objective"]), len(ref["objective"]))
        d_obj = (np.abs(tr["objective"][:T] - ref["objective"][:T])
                 / np.maximum(1.0, np.abs(ref["objective"][:T])))
        ratio = tr["kkt_error"][:T] / np.maximum(ref["kkt_error"][:T], 1e-300)
        parted = (d_obj > 1e-6) | (ratio > 2.0) | (ratio < 0.5)
        first = np.where(parted.any(0), parted.argmax(0) + 1, -1)  # iteration 1-based; -1 never
        never = int((first < 0).sum())
        hist = np.bincount(first[first > 0], minlength=T + 1)[1:]
        print(f"[witness] {name} against cpu f32, first {T} iterations: lanes parted at "
              f"iteration 1..{T}: {hist.tolist()}, never {never}; median over lanes of the "
              f"objective difference {[float(f'{x:.2e}') for x in np.median(d_obj, 1)]}; of the "
              f"KKT ratio {[float(f'{x:.3g}') for x in np.median(ratio, 1)]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args()
    cfg = dense_config()
    kw = dict(cfg["solve_kw"], chunk=min(cfg["solve_kw"]["chunk"], args.lanes))
    if args.witness:
        witness(args.lanes, kw)
    elif args.port:
        import torch

        port_seek("port", args.lanes, kw, "cpu", torch.float32)
    else:
        jax_seek(args.lanes, kw)


if __name__ == "__main__":
    main()
