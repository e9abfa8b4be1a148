"""Drive the PyTorch port of directtrajopt_tpu on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: B=8192 lanes, N=51 knots

Phases, each printing its own lines:

1. Environment: the card's name and power limit, torch / CUDA versions, and
   the seconds the kernel build took (the CUDA sources under
   ``directtrajopt_tpu_torch/csrc`` are compiled at first use).
2. Every kernel of the main path against its plain PyTorch version on the
   card, in float32, at the shapes the pipeline gives it (and the generic
   Riccati kernels at other shapes): deviation, bound, and median CUDA-event
   times of kernel and plain version.
3. The certified two-stage pipeline (Gauss-Newton seek, exact-Hessian
   polish) at B=8192 through ``solve_batch_compact``, with each kernel's
   launch count, the converged share, the KKT error and RMS(u) against the
   golden optimum over the converged lanes.

Exits non-zero if there is no CUDA device, if any kernel fails to build,
launch or agree, if a kernel of the main path was never launched, or if the
pipeline's result does not meet its certificate. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

GOLDEN_RMS = 1e-4  # max RMS(u) against the golden optimum, per converged lane
KKT_CERT = 1e-6  # max KKT error per converged lane
MIN_CONVERGED = 0.99  # share of lanes that must converge
DEVICE = "cuda:0"

KERNELS = {
    # launch-count key: (route, source, TPU kernel it replaces)
    "factor_solve": ("cuda", "directtrajopt_tpu_torch/csrc/riccati_kernel.cu",
                     "directtrajopt_tpu/ops/riccati_kernel.py:342"),
    "resolve": ("cuda", "directtrajopt_tpu_torch/csrc/riccati_kernel.cu",
                "directtrajopt_tpu/ops/riccati_kernel.py:488"),
    "window_jac": ("cuda", "directtrajopt_tpu_torch/csrc/expv_kernel.cu",
                   "directtrajopt_tpu/ops/expv_kernel.py:111"),
    "residual": ("cuda", "directtrajopt_tpu_torch/csrc/expv_kernel.cu",
                 "directtrajopt_tpu/ops/expv_kernel.py:293"),
    "residual_l1": ("cuda", "directtrajopt_tpu_torch/csrc/expv_kernel.cu",
                    "directtrajopt_tpu/ops/expv_kernel.py:293"),
}
# the (n_s, n_v, R) of each Riccati kernel's exact-size instantiation; other
# shapes run the generic kernel (n_s <= 16, n_v <= 8, R <= 8)
EXACT = {"factor_solve": (8, 3, 3), "resolve": (8, 3, 2)}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timed runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def max_dev(ref, out, rel: bool):
    """Max |ref − out| over a tuple of outputs (relative to max(|ref|, 1) per
    output when ``rel``), and the max absolute deviation."""
    worst, worst_abs = 0.0, 0.0
    for x, y in zip(ref, out):
        if x.dtype == torch.bool:
            continue
        d = (x.float() - y.float()).abs().max().item()
        scale = max(x.abs().max().item(), 1.0) if rel else 1.0
        worst = max(worst, d / scale)
        worst_abs = max(worst_abs, d)
    return worst, worst_abs


def stage_data(seed, B, N, dev, ns=8, nv=3, R=3):
    """Well-conditioned random Riccati stage stacks (float32 on ``dev``): the
    generator of the JAX package's Pallas-kernel test, at the slice's sizes."""
    rng = np.random.default_rng(seed)

    def sym(x):
        return 0.5 * (x + np.swapaxes(x, -1, -2))

    Qss = sym(rng.standard_normal((B, N, ns, ns))) * 0.1 + np.eye(ns) * 2.0
    Qsv = rng.standard_normal((B, N, ns, nv)) * 0.1
    Qvv = sym(rng.standard_normal((B, N, nv, nv))) * 0.1 + np.eye(nv) * 2.0
    A = rng.standard_normal((B, N, ns, ns)) * 0.3
    A[:, -1] = 0.0
    Bm = rng.standard_normal((B, N, ns, nv)) * 0.3
    Bm[:, -1] = 0.0
    qs = rng.standard_normal((B, R, N, ns))
    qv = rng.standard_normal((B, R, N, nv))
    b = rng.standard_normal((B, R, N, ns))
    b[:, :, -1] = 0.0
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (Qss, Qsv, Qvv, A, Bm, qs, qv, b)]


def lane_rel(x, ref, mask) -> float:
    """Max over the lanes in ``mask`` of max|x − ref| / max(max|ref|, 1), per lane."""
    d = (x.double() - ref).abs().reshape(x.shape[0], -1).amax(1)
    s = ref.abs().reshape(x.shape[0], -1).amax(1).clamp(min=1.0)
    r = (d / s)[mask]
    return float(r.max()) if r.numel() else 0.0


class Capture:
    """Record the arguments of the first ``n`` calls of a kernel wrapper."""

    def __init__(self, module, name: str, n: int = 1):
        self.module, self.name, self.n = module, name, n
        self.calls: list = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*args):
            if len(self.calls) < self.n:
                self.calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return self.orig(*args)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel from ``nvcc -Xptxas -v`` output: registers and spills."""
    kernels = ("factor_solve_fixed", "factor_solve_generic", "resolve_fixed", "resolve_generic",
               "window_jac_kernel", "residual_kernel", "lane_sum_kernel")
    out, name, frame = [], None, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            m = re.search("(" + "|".join(kernels) + r")(I(?:Li\d+E)+E)?", ln)
            name = None if m is None else m.group(1) + (
                "<" + ",".join(re.findall(r"Li(\d+)E", m.group(2))) + ">" if m.group(2) else "")
        elif name and "stack frame" in ln:
            frame = ln.split(":", 1)[-1].strip()
        elif name and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers; {frame}")
            name = None
    return out


def main() -> None:
    # ---------------- 1. environment ---------------------------------------- #
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script measures the GPU port only")
    from directtrajopt_tpu_torch import benchmarks
    from directtrajopt_tpu_torch.ops import _build, expv_kernel, riccati_kernel
    from directtrajopt_tpu_torch.solvers.solve import cast_problem, solve

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: unavailable"
    print(f"[env] device: {smi_line}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    print(f"[env] kernel build: {time.perf_counter() - t0:.1f} s -> {os.path.basename(info['path'])}")
    for line in ptxas_summary(info.get("log", "")):
        print(f"[ptxas] {line}")

    # ---------------- 2. kernels against their plain versions -------------- #
    cfg = benchmarks.headline_config()
    B, N, order = cfg["batch"], cfg["N"], cfg["taylor_order"]
    prob256 = cast_problem(benchmarks.make_batched_bilinear_problems(
        256, N=N, feasible_start=True, taylor_order=order, device=dev,
        dtype=torch.float64), torch.float32)
    # capture the Riccati kernels' real inputs from a short exact-Hessian solve
    with Capture(riccati_kernel, "factor_solve", 64) as cap_f, \
            Capture(riccati_kernel, "resolve", 64) as cap_r:
        solve(prob256, max_iter=3, compensated_residuals=True)
    results = {}

    def check(name, label, kern, plain, tol, rel, extra_ok=None):
        out_k = kern()
        out_p = plain()
        torch.cuda.synchronize()
        outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
        outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
        dev_rel, dev_abs = max_dev(outs_p, outs_k, rel)
        ms_k, ms_p = cuda_ms(kern), cuda_ms(plain)
        ok = dev_rel <= tol and (extra_ok is None or extra_ok(outs_p, outs_k))
        kind = "relative" if rel else "absolute"
        print(f"[kernel] {label}: max {kind} deviation {dev_rel:.3e} (bound {tol:g}), "
              f"max abs {dev_abs:.3e}; kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms "
              f"-> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{label} disagrees with its plain version")
        results.setdefault(name, dict(max_abs_err=dev_abs, ms=ms_k, plain_ms=ms_p, tol=tol))

    def ok_equal(p, k):
        return bool((p[5] == k[5]).all())

    # K1 / K2 on well-conditioned stage data: the 5e-6 relative bound of the
    # JAX package's own Pallas-kernel test, with the certificate equal. The
    # slice's shapes run the exact-size instantiations; the others, with one
    # indefinite lane each for K1, run the generic kernel.
    s0_slice = cap_f.calls[0][0]

    def riccati_inputs(seed, lanes, ns, nv, R, bad_lane=None):
        """Initial-state mask and stage data; ``bad_lane`` gets an indefinite stage."""
        s0 = s0_slice if ns == len(s0_slice) else np.arange(ns) >= 2
        st = stage_data(seed, lanes, N, dev, ns, nv, R)
        if bad_lane is not None:
            st[2][bad_lane, 20] = -1e6 * torch.eye(nv, device=dev)
            bad = torch.nonzero(~riccati_kernel.factor_solve_plain(s0, *st)[5])[:, 0].tolist()
            if bad != [bad_lane]:
                fail(f"the indefinite fixture must fail the certificate on lane {bad_lane} alone")
        return s0, st

    def instantiation(name, shape):
        return "exact" if EXACT[name] == shape else "generic"

    for key, lanes, shape, bad in (
        ("factor_solve", 256, (8, 3, 3), None),
        ("factor_solve_big", 8192, (8, 3, 3), 77),
        ("factor_solve_generic", 256, (8, 3, 2), 5),
        ("factor_solve_generic_small", 256, (5, 2, 2), 5),
    ):
        s0, st = riccati_inputs(0, lanes, *shape, bad)
        check(key, f"K1 factor_solve ({instantiation('factor_solve', shape)}) B={lanes} "
                   f"(n_s,n_v,R)={shape}" + (f", lane {bad} indefinite" if bad is not None else ""),
              lambda: riccati_kernel.factor_solve(s0, *st),
              lambda: riccati_kernel.factor_solve_plain(s0, *st), 5e-6, True, ok_equal)
    for key, shape in (
        ("resolve", (8, 3, 2)),
        ("resolve_generic", (8, 3, 1)),
        ("resolve_generic_small", (5, 2, 2)),
    ):
        s0, st = riccati_inputs(1, 256, *shape)
        fac = riccati_kernel.factor_solve_plain(s0, *st)
        check(key, f"K2 resolve ({instantiation('resolve', shape)}) B=256 (n_s,n_v,R')={shape}",
              lambda: riccati_kernel.resolve(s0, *fac[:5], *st[3:]),
              lambda: riccati_kernel.resolve_plain(s0, *fac[:5], *st[3:]), 5e-6, True)
    # ... and on the inputs the pipeline gives them (every captured call):
    # the certificate must agree exactly, and on certified lanes each output
    # of the kernel may be no further from a float64 evaluation than 3x the
    # plain float32 version is (worst case over the calls; floor: the 5e-6
    # bound above). Two float32 sweeps of 51 stages legitimately differ by
    # more than 5e-6 on the IPM's conditioning.
    worst = {}
    for label, calls, kern, plain, has_ok in (
        ("K1", cap_f.calls, riccati_kernel.factor_solve, riccati_kernel.factor_solve_plain, True),
        ("K2", cap_r.calls, riccati_kernel.resolve, riccati_kernel.resolve_plain, False),
    ):
        for a in calls:
            k, p32 = kern(*a), plain(*a)
            p64 = plain(a[0], *(t.double() for t in a[1:]))
            if has_ok:
                if not (bool((k[5] == p64[5]).all()) and bool((p32[5] == p64[5]).all())):
                    fail("K1 certificate disagrees on pipeline inputs")
                mask = p64[5]
                k, p32, p64 = (tuple(t for i, t in enumerate(o) if i != 5) for o in (k, p32, p64))
            else:
                mask = torch.ones(a[1].shape[0], dtype=torch.bool, device=dev)
            for i, (x, y, z) in enumerate(zip(k, p32, p64)):
                ek, ep = worst.get((label, i), (0.0, 0.0))
                worst[(label, i)] = (max(ek, lane_rel(x, z, mask)), max(ep, lane_rel(y, z, mask)))
    ratio = max(ek / max(ep, 5e-6) for ek, ep in worst.values())
    print(f"[kernel] K1/K2 on {len(cap_f.calls)}+{len(cap_r.calls)} captured pipeline calls: "
          f"certificates equal; worst output's (kernel vs f64) / max(plain f32 vs f64, 5e-6) "
          f"= {ratio:.2f} (bound 3)", flush=True)
    if ratio > 3.0:
        fail("K1/K2 are less accurate than their plain versions on pipeline inputs")

    prob_big = cast_problem(benchmarks.make_batched_bilinear_problems(
        B, N=N, feasible_start=True, taylor_order=order, device=dev,
        dtype=torch.float64), torch.float32)
    integ = prob_big.integrators[0]
    layout = prob_big.trajectory.layout
    Gd, Gv, u, dt, x, xn = integ._lane_args(layout, prob_big.trajectory.knot_matrix())
    check("window_jac", f"K3 window_jac B={B} x {x.shape[1]} windows",
          lambda: expv_kernel.window_jac(order, True, Gd, Gv, u, dt, x),
          lambda: expv_kernel.window_jac_plain(order, True, Gd, Gv, u, dt, x), 2e-6, False)
    # K4 on the seek's trial grid: lanes = 256 problems x (max_ls + 2) slots
    n_slots = cfg["phase1_kw"]["max_ls"] + 2
    Z = prob256.trajectory.to_zvec()
    rng = np.random.default_rng(0)
    dZ = torch.as_tensor(1e-3 * rng.standard_normal(Z.shape), dtype=torch.float32, device=dev)
    alphas = torch.as_tensor(0.5 ** np.arange(n_slots), dtype=torch.float32, device=dev)
    Zt = (Z[:, None] + alphas[None, :, None] * dZ[:, None]).reshape(
        Z.shape[0], n_slots, layout.N, layout.dim)
    targs = prob256.integrators[0]._lane_args(layout, Zt)  # 256 problems x grid slots
    check("residual_l1", f"K4 residual (L1 form) lanes=256x{n_slots}",
          lambda: expv_kernel.residual_l1(order, *targs),
          lambda: expv_kernel.residual_l1_plain(order, *targs), 2e-6, False)
    check("residual", f"K4 residual (vector form) lanes=256x{n_slots}",
          lambda: expv_kernel.residual_action(order, *targs),
          lambda: expv_kernel.residual_action_plain(order, *targs), 2e-6, False)

    # ---------------- 3. the pipeline -------------------------------------- #
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    times = {}
    res2, res1 = benchmarks.run_headline(prob_big, cfg, times)
    launches = dict(_build.LAUNCHES)
    t_seek, t_polish = times["seek"], times["polish"]

    conv = res2.converged.cpu().numpy()
    kkt = res2.kkt_error.cpu().numpy()
    lanes = np.nonzero(conv)[0]
    rms = benchmarks.rms_u_vs_golden(res2, lanes)
    it1, it2 = res1.iterations.cpu().numpy(), res2.iterations.cpu().numpy()
    print(f"[pipeline] B={B} N={N} float32: seek {t_seek:.2f} s, "
          f"polish {t_polish:.2f} s, total {t_seek + t_polish:.2f} s")
    print(f"[pipeline] seek converged {int(res1.converged.sum())}/{B}; "
          f"iterations median {np.median(it1):g} max {it1.max()}")
    print(f"[pipeline] polish converged {len(lanes)}/{B}; "
          f"iterations median {np.median(it2):g} max {it2.max()}")
    kkt_max = float(kkt[lanes].max()) if len(lanes) else float("nan")
    rms_max = float(rms.max()) if len(lanes) else float("nan")
    print(f"[pipeline] over converged lanes: max kkt {kkt_max:.3e} (bound {KKT_CERT:g}), "
          f"max RMS(u) vs golden {rms_max:.3e} (bound {GOLDEN_RMS:g})")
    print(f"[pipeline] kernel launches: {json.dumps(launches)}; "
          f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    kkt1, st2 = res1.kkt_error.cpu().numpy(), res2.status.cpu().numpy()
    for i in np.nonzero(~conv)[0][:16]:
        print(f"[pipeline] unconverged lane {i}: seek {it1[i]} iterations, kkt {kkt1[i]:.3e}; "
              f"polish {it2[i]} iterations, kkt {kkt[i]:.3e}, status {st2[i]}")

    if any(v == 0 for v in launches.values()):
        fail(f"a kernel of the main path was never launched: {launches}")
    if len(lanes) < MIN_CONVERGED * B:
        fail(f"only {len(lanes)}/{B} lanes converged")
    if not (kkt_max <= KKT_CERT and rms_max < GOLDEN_RMS):
        fail("a converged lane is not certified")

    table = []
    for name, (route, src, replaces) in KERNELS.items():
        r = results[name]
        table.append(dict(name=name, route=route, source=src, replaces=replaces,
                          launches=launches[name], max_abs_err=r["max_abs_err"],
                          ms=r["ms"], plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": table}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
