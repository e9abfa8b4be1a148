"""Time the K3 rows of ``chip_smoke.py`` with the port's package from a given
checkout, on one GPU, so that two versions compare in one call.

    python3 tools/torch_k3_rows.py [--root DIR]

K3 (the window Jacobian) at three exact shapes: path 1's compact chunk
(256 problems, 4-D state, 2 drives, free Δt, order 6), the same problem at
8192 lanes, and path 2's call (8192 lanes, 2-D state, 1 drive, fixed Δt,
order 12); then at shapes of the size-class kernels (the generic
instantiation in older trees): path 7c's call (128 lanes of the scaling
family at state_dim 8, 2 drives, free Δt, Taylor order 12, on its knot
matrix) and the seeded 2048-lane calls of ``chip_smoke.py`` at (3,1),
(6,2) and (8,8) (``window_jac``, free Δt, order 12). For each exact shape
it prints the wrapper time (CUDA events, median of 20 lone
calls), the time per call of 20 calls back to back and the kernel's device
time per launch from ``torch.profiler``, first for the kernel call alone and
then for the integrator's entry ``jacobians_zk_stacked``, which includes
making the kernel's arguments and placing its columns into the knot's width.
The entry's row adds the device operations (kernels and copies) the
profiler records per call, with their names, and a SHA-256 digest of its
output, which two versions share where they compute bitwise the same. Each
row's time bound is this checkout's ``chip_smoke.py`` count (the views and
generators read once, the d-wide output written once), so every tree is
held to the same bound. Each size-class row prints the same three times,
its bound and the SHA-256 digest of the kernel's output. DIR
defaults to this checkout; give the parent's tree unpacked into a directory
``.gitignore`` lists, and run parent and change in turns.
"""
import argparse
import hashlib
import importlib.util
import sys
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--root", default=str(HERE), help="checkout whose package is timed")
a = ap.parse_args()
sys.path.insert(0, str(Path(a.root).resolve()))
import torch  # noqa: E402

# this checkout's timers, whichever package is timed
_spec = importlib.util.spec_from_file_location("chip_smoke_timers", HERE / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from directtrajopt_tpu_torch import benchmarks  # noqa: E402
from directtrajopt_tpu_torch.ops import _build, expv_kernel as ek  # noqa: E402
from directtrajopt_tpu_torch.solvers.solve import cast_problem  # noqa: E402

print("package:", benchmarks.__file__, flush=True)
dev = torch.device("cuda:0")
_build.library()
# the kernels' names share this prefix in every tree (window_jac_kernel,
# window_jac_classed); one call launches one kernel
KNAME = "window_jac_"
for kname, regs, frame, smem in cs.ptxas_summary(_build.build_info().get("log", "")):
    if kname.startswith(KNAME):
        print(f"[ptxas] {kname}: {regs} registers; {frame}", flush=True)


def device_ops(fn, calls: int = 20):
    """Device operations per call of ``fn`` (kernels, copies, fills) as
    ``torch.profiler`` records them, and their names with counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            names[e.name[:60]] += 1
    return sum(names.values()) / calls, {k: v / calls for k, v in names.items()}


def row(name, fn, bound, ops=False):
    ms, b2b = cs.cuda_ms(fn), cs.cuda_ms_back_to_back(fn)
    d = cs.device_ms(fn, KNAME)
    txt = (f"{name}: wrapper {ms:.4f} ms, back to back {b2b:.4f} ms, device "
           f"{'n/a' if d is None else f'{d:.4f}'} ms; bound {bound:.4f} ms, "
           f"{bound / (ms if d is None else d):.1%} of it reached by the "
           f"{'wrapper' if d is None else 'device'} time")
    if ops:
        n, names = device_ops(fn)
        txt += f", device ops per call {n:g} {dict(names)}"
    print(txt, flush=True)


cfg = benchmarks.headline_config()
N, order = cfg["N"], cfg["taylor_order"]
sc = benchmarks.state_constrained_config()
for label, mk in (("<4,2> path 1 B=256", lambda: benchmarks.make_batched_bilinear_problems(
        256, N=N, feasible_start=True, taylor_order=order, device=dev, dtype=torch.float64)),
                  ("<4,2> B=8192", lambda: benchmarks.make_batched_bilinear_problems(
        cfg["batch"], N=N, feasible_start=True, taylor_order=order, device=dev,
        dtype=torch.float64)),
                  ("<2,1> path 2 B=8192", lambda: benchmarks.make_batched_state_constrained_problems(
        sc["batch"], N=sc["N"], device=dev))):
    prob = cast_problem(mk(), torch.float32)
    integ, lay = prob.integrators[0], prob.trajectory.layout
    zm = prob.trajectory.knot_matrix()
    o = integ.taylor_order
    # the bound of this checkout's chip_smoke.py, for every tree: the views
    # u, Δt, x and the generators (K4's views without x_next, which every
    # version has) read once, the (B, N−1, x_dim, d) output written once
    views = integ._trial_views(lay, zm)[:5]
    P, _, K, xd = views[4].shape
    nd = views[1].shape[1]
    bound, by = cs.time_bound(cs.nbytes(views) + P * K * xd * lay.dim * 4,
                              cs.horner_ops(P, K, xd, nd, o, True, lay.has_free_time))
    print(f"K3 {label}: time bound {bound:.4f} ms ({by})", flush=True)
    if hasattr(ek, "window_jac_zk"):
        v = integ._window_jac_args(lay, zm)
        row(f"K3 {label} kernel (views, d-wide)", lambda: ek.window_jac_zk(o, *v), bound)
    else:
        v = integ._lane_args(lay, zm)[:5]
        row(f"K3 {label} kernel (lane copies)",
            lambda: ek.window_jac(o, lay.has_free_time, *v), bound)
    row(f"K3 {label} entry jacobians_zk_stacked", lambda: integ.jacobians_zk_stacked(lay, zm),
        bound, ops=True)
    out = integ.jacobians_zk_stacked(lay, zm)
    print(f"K3 {label} entry output: sha256 "
          f"{hashlib.sha256(out.contiguous().cpu().numpy().tobytes()).hexdigest()[:20]}",
          flush=True)
    del prob, integ, zm, v, views, out
    torch.cuda.empty_cache()


def sha(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:20]


# path 7c's call on its knot matrix, then the seeded calls
prob = cs.scaled_batch(128, 51, 8, taylor_order=12, dev=dev)
integ, lay = prob.integrators[0], prob.trajectory.layout
zm = prob.trajectory.knot_matrix()
views = integ._trial_views(lay, zm)[:5]
P, _, K, xd = views[4].shape
bound, by = cs.time_bound(cs.nbytes(views) + P * K * xd * lay.dim * 4,
                          cs.horner_ops(P, K, xd, 2, 12, True, lay.has_free_time))
print(f"K3 (8,2) path 7c B=128: time bound {bound:.4f} ms ({by})", flush=True)
v = integ._window_jac_args(lay, zm)
row("K3 (8,2) path 7c B=128 kernel (views, d-wide)", lambda: ek.window_jac_zk(12, *v), bound)
print(f"K3 (8,2) path 7c B=128 output: sha256 {sha(ek.window_jac_zk(12, *v))}", flush=True)
del prob, integ, zm, views, v
for xd, nd in cs.SEEDED_EXPV:
    ins = cs.seeded_expv(xd, nd, dev)[:5]
    L, K = ins[3].shape
    bound, by = cs.time_bound(cs.nbytes(ins) + L * K * xd * (xd + nd + 1) * 4,
                              cs.horner_ops(L, K, xd, nd, 12, True, True))
    label = f"K3 ({xd},{nd}) seeded B={L} x {K}"
    print(f"{label}: time bound {bound:.4f} ms ({by})", flush=True)
    row(f"{label} window_jac", lambda: ek.window_jac(12, True, *ins), bound)
    print(f"{label} output: sha256 {sha(ek.window_jac(12, True, *ins))}", flush=True)
    del ins
    torch.cuda.empty_cache()
