"""Fingerprint the PyTorch port's K1-K4 outputs on fixed inputs, on
one GPU, to show whether two versions of the port compute bitwise the same.

    python3 tools/torch_pair_outputs.py OUT.json [--root DIR] [--path7e CALLS.pt]
    python3 tools/torch_pair_outputs.py --compare A.json B.json

The first form imports ``directtrajopt_tpu_torch`` from DIR (default: this
checkout), builds its kernels and writes a SHA-256 digest of the inputs and
of the outputs of each row:

- K4, both forms, on the trial grids ``chip_smoke.py`` checks (path 1: 256
  problems × 9 slots; path 2: 8192 × 12), through
  ``BilinearIntegrator.residuals_stacked`` / ``residuals_l1_stacked``, the
  entries every version has;
- K3 through ``BilinearIntegrator.jacobians_zk_stacked`` on the knot matrix
  of path 1's problem at 256 and 8192 lanes and of path 2's at 8192 (its
  output, the z_k-wide Jacobian, is the same function in every version);
- K1 at (8,3,3) on random stage data for 256 lanes and for 8192 (lane 77
  indefinite), at (2,1,7) on random stage data for 8192 (lane 77
  indefinite), and at (2,1,3) on the first call captured from path 2's own
  solve (one certified lane made indefinite);
- K2 at (8,3,2) for 256 lanes against K1's factors, and at (2,1,2) on the
  first call captured from path 2's solve;
- on random stage data at N=51, 128 lanes (path 7's chunk), lane 5
  indefinite for K1: the grouped K1 at (10,3,3), (18,3,3) and K2 at
  (10,3,2), (18,3,2); K1 at (5,2,2) and (6,3,3) (path 7e's) and K2 at
  (5,2,40) (five tiles) and (6,3,2); K1 and K2 at (24,24,8) on 32 lanes
  (the size-class kernels at these shapes); and, at N=40, 8192 lanes (path
  5's batch), K1 (4,1,1) and K2 (4,1,2) and (4,1,40), whose kernels a
  version may have changed;
- the generic K3/K4 (``window_jac`` / ``residual_action`` /
  ``residual_l1``) at (3,1), 256 lanes × 50 windows, free Δt.

With ``--path7e CALLS.pt`` it also runs path 7e with the package in DIR
(``chip_smoke.SUB7["7e"]``: the scaling family at state_dim 4, N=51,
Padé, ``scaled_config()``'s chunk of 128 lanes) and writes its seconds,
converged count, iterations and launches (by kernel and by CUDA kernel),
then times K1 and K2 on the first calls captured from that solve (wrapper
ms, CUDA events, median of 20; device ms a launch, ``torch.profiler``, 20
calls) against the plain versions, and K1 and K2 at the range's corner,
(24,24,8) × 256 lanes, seeded as ``chip_smoke.py`` seeds them (3 calls).
The captured calls are saved to CALLS.pt where it does not exist yet and
read from it where it does, so that a second package is timed on the
first one's calls.

The second form prints, row by row, whether two such files agree on the
inputs and on the outputs, bit for bit. Run both forms in one call on the
card, the parent's tree unpacked into a directory ``.gitignore`` lists.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

BIG = 8192  # lanes of the second K1 row (path 1's batch)
DEVICE = "cuda:0"


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:20]


def chip_smoke():
    """This checkout's ``chip_smoke.py``, for its fixtures (stage data,
    call capture), whichever package is fingerprinted."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_fixtures", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fingerprint(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from directtrajopt_tpu_torch import benchmarks
    from directtrajopt_tpu_torch.ops import riccati_kernel as rk
    from directtrajopt_tpu_torch.solvers.options import IPMOptions
    from directtrajopt_tpu_torch.solvers.solve import cast_problem, solve

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script fingerprints the GPU kernels")
    cs = chip_smoke()
    dev = torch.device(DEVICE)
    rows = {}

    def row(name, ins, fn):
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        rows[name] = dict(inputs=digest(ins), outputs=digest(out))
        print(f"{name}: inputs {rows[name]['inputs']} outputs {rows[name]['outputs']}",
              flush=True)

    def grid(prob, n_slots, rng):
        Z = prob.trajectory.to_zvec()
        dZ = torch.as_tensor(1e-3 * rng.standard_normal(Z.shape), dtype=torch.float32, device=dev)
        al = torch.as_tensor(0.5 ** np.arange(n_slots), dtype=torch.float32, device=dev)
        lay = prob.trajectory.layout
        return (Z[:, None] + al[None, :, None] * dZ[:, None]).reshape(
            Z.shape[0], n_slots, lay.N, lay.dim)

    # K4 on both paths' trial grids, as chip_smoke.py builds them
    cfg = benchmarks.headline_config()
    N, order = cfg["N"], cfg["taylor_order"]
    prob256 = cast_problem(benchmarks.make_batched_bilinear_problems(
        256, N=N, feasible_start=True, taylor_order=order, device=dev,
        dtype=torch.float64), torch.float32)
    rng = np.random.default_rng(0)
    Zt = grid(prob256, cfg["phase1_kw"]["max_ls"] + 2, rng)
    integ, lay = prob256.integrators[0], prob256.trajectory.layout
    gens = [integ.G_drift, integ.G_drives]
    row("K4 vector, path 1", gens + [Zt], lambda: integ.residuals_stacked(lay, Zt))
    row("K4 L1, path 1", gens + [Zt], lambda: integ.residuals_l1_stacked(lay, Zt))
    sc_cfg = benchmarks.state_constrained_config()
    prob_sc = cast_problem(benchmarks.make_batched_state_constrained_problems(
        sc_cfg["batch"], N=sc_cfg["N"], device=dev), torch.float32)
    Zt2 = grid(prob_sc, IPMOptions().max_ls + 2, rng)
    integ2, lay2 = prob_sc.integrators[0], prob_sc.trajectory.layout
    gens2 = [integ2.G_drift, integ2.G_drives]
    row("K4 vector, path 2", gens2 + [Zt2], lambda: integ2.residuals_stacked(lay2, Zt2))
    row("K4 L1, path 2", gens2 + [Zt2], lambda: integ2.residuals_l1_stacked(lay2, Zt2))

    # K3 through the integrator's entry, on each problem's knot matrix
    prob_big = cast_problem(benchmarks.make_batched_bilinear_problems(
        BIG, N=N, feasible_start=True, taylor_order=order, device=dev,
        dtype=torch.float64), torch.float32)
    for name, prob in (("K3 <4,2> path 1 B=256", prob256), (f"K3 <4,2> B={BIG}", prob_big),
                       (f"K3 <2,1> path 2 B={sc_cfg['batch']}", prob_sc)):
        ig, ly, zm = prob.integrators[0], prob.trajectory.layout, prob.trajectory.knot_matrix()
        row(name, [ig.G_drift, ig.G_drives, zm], lambda: ig.jacobians_zk_stacked(ly, zm))
    del prob_big

    # K1 and K2 on random stage data
    s0 = np.arange(8) >= 2
    st = cs.stage_data(0, 256, N, dev, 8, 3, 3)
    row("K1 (8,3,3) B=256", st, lambda: rk.factor_solve(s0, *st))
    st = cs.stage_data(0, BIG, N, dev, 8, 3, 3)
    st[2][77, 20] = -1e6 * torch.eye(3, device=dev)
    row(f"K1 (8,3,3) B={BIG}, lane 77 indefinite", st, lambda: rk.factor_solve(s0, *st))
    st = cs.stage_data(2, BIG, N, dev, 2, 1, 7)
    st[2][77, 20] = -1e6
    row(f"K1 (2,1,7) B={BIG}, lane 77 indefinite", st,
        lambda: rk.factor_solve(np.arange(2) >= 1, *st))
    st = cs.stage_data(1, 256, N, dev, 8, 3, 2)
    fac = rk.factor_solve_plain(s0, *st)
    ins = list(fac[:5]) + st[3:]
    row("K2 (8,3,2) B=256", ins, lambda: rk.resolve(s0, *ins))

    # K1 and K2 on the first calls of path 2's own solve
    kw2 = {k: v for k, v in sc_cfg["solve_kw"].items() if k not in ("phases", "chunk")}
    with cs.Capture(rk, "factor_solve") as cap_f, cs.Capture(rk, "resolve") as cap_r:
        solve(prob_sc, max_iter=3, **kw2)
    f_args, r_args = list(cap_f.calls[0]), cap_r.calls[0]
    bad = int(torch.nonzero(rk.factor_solve_plain(*f_args)[5])[0, 0])
    f_args[3] = f_args[3].clone()
    f_args[3][bad, 20] = -1e6
    row("K1 (2,1,3) path-2 call, one lane indefinite", f_args[1:],
        lambda: rk.factor_solve(*f_args))
    row("K2 (2,1,2) path-2 call", r_args[1:], lambda: rk.resolve(*r_args))
    del cap_f, cap_r, f_args, r_args

    # the other K1/K2 instantiations on random stage data
    for lanes, n_knots, ns, nv, R, R2 in ((128, N, 10, 3, 3, 2), (128, N, 18, 3, 3, 2),
                                          (128, N, 5, 2, 2, 40), (128, N, 6, 3, 3, 2),
                                          (32, N, 24, 24, 8, 8),
                                          (BIG, 40, 4, 1, 1, 2), (BIG, 40, 4, 1, 1, 40)):
        s0n = np.arange(ns) >= 2
        st = cs.stage_data(30 + ns, lanes, n_knots, dev, ns, nv, R)
        st[2][5, 20] = -1e6 * torch.eye(nv, device=dev)
        if R2 == 2:  # one K1 row a shape
            row(f"K1 ({ns},{nv},{R}) B={lanes}, lane 5 indefinite", st,
                lambda: rk.factor_solve(s0n, *st))
        st2 = cs.stage_data(40 + ns, lanes, n_knots, dev, ns, nv, R2)
        fac = rk.factor_solve_plain(s0n, *st2[:5], *(x[:, :1] for x in st2[5:]))
        ins = list(fac[:5]) + st2[3:]
        row(f"K2 ({ns},{nv},{R2}) B={lanes}", ins, lambda: rk.resolve(s0n, *ins))
        del st, st2, fac, ins

    # the generic K3/K4 at (3,1)
    from directtrajopt_tpu_torch.ops import expv_kernel as ek

    g = np.random.default_rng(31)
    Gd, Gv, u, dt, x, xn = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
        0.5 * g.normal(size=(256, 3, 3)), 0.5 * g.normal(size=(256, 1, 3, 3)),
        0.3 * g.normal(size=(256, 50, 1)), 0.1 + 0.05 * g.random((256, 50)),
        g.normal(size=(256, 50, 3)), g.normal(size=(256, 50, 3))))
    ins4 = (Gd, Gv, u[:, None], dt[:, None], x[:, None], xn[:, None])
    row("K3 generic (3,1) B=256 x 50", (Gd, Gv, u, dt, x),
        lambda: ek.window_jac(12, True, Gd, Gv, u, dt, x))
    row("K4 vector generic (3,1) B=256 x 50", ins4, lambda: ek.residual_action(12, *ins4))
    row("K4 L1 generic (3,1) B=256 x 50", ins4, lambda: ek.residual_l1(12, *ins4))
    return dict(root=str(root), device=torch.cuda.get_device_name(0), rows=rows)


def path7e(calls: Path) -> dict:
    """Path 7e's solve with the imported package, and K1 / K2 timed on the
    first calls captured from it (or from ``calls``, where it exists)."""
    import torch

    from directtrajopt_tpu_torch import benchmarks
    from directtrajopt_tpu_torch.ops import _build
    from directtrajopt_tpu_torch.ops import riccati_kernel as rk
    from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact

    cs = chip_smoke()
    cfg = benchmarks.scaled_config()
    dim, order = cs.SUB7["7e"]
    prob = cs.scaled_batch(cfg["batch"], cfg["N"], dim, taylor_order=order, dev=DEVICE)
    _build.library()
    torch.cuda.synchronize()
    _build.reset_launches()
    with cs.Capture(rk, "factor_solve", 1) as cap_f, cs.Capture(rk, "resolve", 1) as cap_r:
        t0 = time.perf_counter()
        res = solve_batch_compact(prob, **cfg["solve_kw"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    it = res.iterations.cpu().numpy()
    out = dict(seconds=seconds, lanes=cfg["batch"], converged=int(res.converged.sum()),
               iterations_median=float(np.median(it)), iterations_max=int(it.max()),
               launches={k: v for k, v in _build.LAUNCHES.items() if v},
               instances=dict(_build.INSTANCES),
               plain_calls={k: v for k, v in _build.PLAIN_CALLS.items() if v})
    if calls.exists():
        f_args, r_args = torch.load(calls, map_location=DEVICE, weights_only=False)
        out["calls"] = f"read from {calls}"
    else:
        f_args, r_args = cap_f.calls[0], cap_r.calls[0]
        torch.save((f_args, r_args), calls)
        out["calls"] = f"captured here, saved to {calls}"
    for key, kern, plain, args in (("factor_solve", rk.factor_solve, rk.factor_solve_plain, f_args),
                                   ("resolve", rk.resolve, rk.resolve_plain, r_args)):
        k, p = kern(*args), plain(*args)
        dev_rel, _ = cs.max_dev([x for x in p if x.dtype != torch.bool],
                                [x for x in k if x.dtype != torch.bool], True)
        ns, nv, R = args[1].shape[-1], args[3 if key == "factor_solve" else 2].shape[-1], \
            args[6 if key == "factor_solve" else 8].shape[1]
        out[key] = dict(shape=[ns, nv, R], design=rk.design(key, ns, nv, R),
                        ms=cs.cuda_ms(lambda: kern(*args)),
                        device_ms=cs.device_ms(lambda: kern(*args), key),
                        plain_ms=cs.cuda_ms(lambda: plain(*args), 5), max_rel_dev=dev_rel)
    # the range's corner, seeded as chip_smoke.py seeds it: K1 with lane 5
    # indefinite, K2 on the plain factors of well-conditioned data
    s0 = np.arange(24) >= 2
    st = cs.stage_data(6, 256, 51, DEVICE, 24, 24, 8)
    st[2][5, 20] = -1e6 * torch.eye(24, device=DEVICE)
    st2 = cs.stage_data(7, 256, 51, DEVICE, 24, 24, 8)
    fac = rk.factor_solve_plain(s0, *st2)
    for key, fn in (("factor_solve", lambda: rk.factor_solve(s0, *st)),
                    ("resolve", lambda: rk.resolve(s0, *fac[:5], *st2[3:]))):
        out[f"corner_{key}"] = dict(shape=[24, 24, 8], lanes=256, ms=cs.cuda_ms(fn, 3),
                                    device_ms=cs.device_ms(fn, key, 3))
    print("[path7e] " + json.dumps(out), flush=True)
    return out


def compare(a: dict, b: dict) -> bool:
    same_all = True
    print(f"A: {a['root']} ({a['device']})\nB: {b['root']} ({b['device']})")
    for name, ra in a["rows"].items():
        rb = b["rows"].get(name)
        if rb is None:
            print(f"{name}: missing in B")
            same_all = False
            continue
        same_in, same_out = ra["inputs"] == rb["inputs"], ra["outputs"] == rb["outputs"]
        same_all &= same_in and same_out
        print(f"{name}: inputs {'equal' if same_in else 'DIFFER'}, outputs "
              f"{'bitwise equal' if same_out else 'DIFFER'}")
    return same_all


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--path7e", metavar="CALLS.pt", type=Path)
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(Path(f).read_text()) for f in args.files)
        compare(a, b)
        return
    out = fingerprint(Path(args.root).resolve())
    if args.path7e:
        out["path7e"] = path7e(args.path7e)
    Path(args.files[0]).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
