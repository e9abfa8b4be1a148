"""Time the K2 and K4 rows of ``chip_smoke.py`` with the port's package from
a given checkout, on one GPU, so that two versions compare in one call.

    python3 tools/torch_k2k4_rows.py [--root DIR] [--path1]

For K4 on both paths' trial grids (path 1: 256 problems × 9 slots; path 2:
8192 × 12), in both forms, it prints the wrapper time (CUDA events, median
of 20 lone calls), the time per call of 20 calls back to back and the
kernels' device time per call from ``torch.profiler``, first for the
kernel call alone and then for the integrator's entry
(``residuals_stacked`` / ``residuals_l1_stacked``), which includes making
the kernel's arguments (copies in older versions of the port, views now). Then K2 at
(8,3,2) for 256 lanes and at (2,1,2) on path 2's first captured call, and
with ``--path1`` path 1 end to end at B=8192. Last, K4 at shapes of the
size-class kernels (the generic instantiation in older trees), both
forms: path 7c's trial grid (128 lanes of the scaling family at state_dim
8, Taylor order 12, max_ls + 2 slots) and the seeded 2048-lane calls of
``chip_smoke.py`` at (3,1), (6,2) and (8,8); each row with its time bound
from this checkout's ``chip_smoke.py`` and the SHA-256 digest of its
output. DIR defaults to this
checkout; give the parent's tree unpacked into a directory ``.gitignore``
lists, and run parent and change in turns.
"""
import argparse
import hashlib
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--root", default=str(HERE), help="checkout whose package is timed")
ap.add_argument("--path1", action="store_true", help="also run path 1 end to end")
a = ap.parse_args()
sys.path.insert(0, str(Path(a.root).resolve()))
import torch  # noqa: E402

# this checkout's timers, whichever package is timed
_spec = importlib.util.spec_from_file_location("chip_smoke_timers", HERE / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from directtrajopt_tpu_torch import benchmarks  # noqa: E402
from directtrajopt_tpu_torch.ops import _build, expv_kernel as ek, riccati_kernel as rk  # noqa: E402
from directtrajopt_tpu_torch.solvers.options import IPMOptions  # noqa: E402
from directtrajopt_tpu_torch.solvers.solve import cast_problem, solve  # noqa: E402

print("package:", benchmarks.__file__, flush=True)
dev = torch.device("cuda:0")
_build.library()


def row(name, fn, knames):
    ms, b2b = cs.cuda_ms(fn), cs.cuda_ms_back_to_back(fn)
    ds = [cs.device_ms(fn, k) for k in knames]
    d = None if None in ds else sum(ds)
    print(f"{name}: wrapper {ms:.4f} ms, back to back {b2b:.4f} ms, device "
          f"{'n/a' if d is None else f'{d:.4f}'} ms", flush=True)


def args_of(integ, lay, Zt):
    if hasattr(integ, "_trial_views"):
        return integ._trial_views(lay, Zt), ("residual_grid_kernel",)
    return integ._lane_args(lay, Zt), ("residual_kernel",)


cfg = benchmarks.headline_config()
N, order = cfg["N"], cfg["taylor_order"]
rng = np.random.default_rng(0)
for B, T, mk in ((256, cfg["phase1_kw"]["max_ls"] + 2, "bil"), (8192, IPMOptions().max_ls + 2, "sc")):
    if mk == "bil":
        prob = cast_problem(benchmarks.make_batched_bilinear_problems(
            B, N=N, feasible_start=True, taylor_order=order, device=dev, dtype=torch.float64),
            torch.float32)
    else:
        sc = benchmarks.state_constrained_config()
        prob = cast_problem(benchmarks.make_batched_state_constrained_problems(
            sc["batch"], N=sc["N"], device=dev), torch.float32)
    integ, lay = prob.integrators[0], prob.trajectory.layout
    o = integ.taylor_order
    Z = prob.trajectory.to_zvec()
    dZ = torch.as_tensor(1e-3 * rng.standard_normal(Z.shape), dtype=torch.float32, device=dev)
    al = torch.as_tensor(0.5 ** np.arange(T), dtype=torch.float32, device=dev)
    Zt = (Z[:, None] + al[None, :, None] * dZ[:, None]).reshape(Z.shape[0], T, lay.N, lay.dim)
    v, kname = args_of(integ, lay, Zt)
    for label, fn in (("L1", ek.residual_l1), ("vector", ek.residual_action)):
        kn = kname + (("lane_sum_kernel",) if label == "L1" and kname[0] == "residual_kernel" else ())
        row(f"K4 {label} {mk} {tuple(Zt.shape)}", lambda: fn(o, *v), kn)
        row(f"K4 {label} {mk} entry incl. args", lambda: (integ.residuals_l1_stacked if label == "L1"
                                                          else integ.residuals_stacked)(lay, Zt), kn)
    if mk == "sc":
        kw2 = {k: v for k, v in sc["solve_kw"].items() if k not in ("phases", "chunk")}
        with cs.Capture(rk, "resolve", 1) as cap:
            solve(prob, max_iter=3, **kw2)
        r = cap.calls[0]
        row("K2 (2,1,2) path-2 call", lambda: rk.resolve(*r), ("resolve_",))
s0 = np.arange(8) >= 2
st = cs.stage_data(1, 256, N, dev, 8, 3, 2)
fac = rk.factor_solve_plain(s0, *st)
row("K2 (8,3,2) B=256", lambda: rk.resolve(s0, *fac[:5], *st[3:]), ("resolve_",))
if a.path1:
    prob_big = cast_problem(benchmarks.make_batched_bilinear_problems(
        cfg["batch"], N=N, feasible_start=True, taylor_order=order, device=dev,
        dtype=torch.float64), torch.float32)
    torch.cuda.synchronize()
    times = {}
    t0 = time.perf_counter()
    res2, res1 = benchmarks.run_headline(prob_big, cfg, times)
    print(f"path 1: seek {times['seek']:.2f} s polish {times['polish']:.2f} s total "
          f"{time.perf_counter() - t0:.2f} s; polish converged {int(res2.converged.sum())}",
          flush=True)



def sha(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:20]


def k4_rows(label, args, n_ops):
    bound, by = cs.time_bound(cs.nbytes(args), n_ops)
    print(f"{label}: time bound {bound:.4f} ms ({by})", flush=True)
    for form, fn in (("L1", ek.residual_l1), ("vector", ek.residual_action)):
        row(f"{label} {form}", lambda: fn(12, *args), ("residual_",))
        print(f"{label} {form} output: sha256 {sha(fn(12, *args))}", flush=True)


prob = cs.scaled_batch(128, 51, 8, taylor_order=12, dev=dev)
lay = prob.trajectory.layout
Zt = cs.trial_grid_7c(prob, dev)
v = prob.integrators[0]._trial_views(lay, Zt)
k4_rows(f"K4 (8,2) path 7c {tuple(Zt.shape)}", v,
        cs.horner_ops(Zt.shape[0] * Zt.shape[1], lay.N - 1, 8, 2, 12, False))
del prob, Zt, v
for xd, nd in cs.SEEDED_EXPV:
    Gd, Gv, u, dt, x, xn = cs.seeded_expv(xd, nd, dev)
    L, K = dt.shape
    k4_rows(f"K4 ({xd},{nd}) seeded B={L} x {K}",
            (Gd, Gv, u[:, None], dt[:, None], x[:, None], xn[:, None]),
            cs.horner_ops(L, K, xd, nd, 12, False))
    del Gd, Gv, u, dt, x, xn
    torch.cuda.empty_cache()
