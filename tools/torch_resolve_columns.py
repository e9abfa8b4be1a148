"""Time the cartpole family's K1/K2 kernels on one GPU: the column K2 and the
grouped K1/K2 at (n_s, n_v) = (4, 1), beside the size-class kernels.

    python3 tools/torch_resolve_columns.py [--variants 4:128,2:128,...]

``resolve_columns<4,1>`` runs a thread per (lane, right-hand side) with the
lanes' stored blocks staged in shared memory
(``directtrajopt_tpu_torch/csrc/riccati_kernel.cu``). The script loads the
library (where it builds it, it prints these kernels' registers, stack
frames and shared memory from ``-Xptxas -v``), then, on seeded
well-conditioned stage data (``chip_smoke.stage_data``) at N=40 and 8192
lanes (path 5's batch) with the initial state pinned, times K1 (4,1,1)
(lane 5 indefinite) and K2 at R' = 1, 2, 8 and 40 against the factors of
the plain K1. Per row: the wrapper time (CUDA events, median), back to
back, the device time per launch (``torch.profiler``), the size-class
kernel on the same inputs (``factor_solve_classed`` /
``resolve_classed``: device time), the plain version's time, the max
relative deviation from it (off the indefinite lane), the time bound
(``chip_smoke.time_bound``) and the design's own traffic: every input and
output once, plus the stashed p_k, kff_k written and read back and b read
a second time in the forward sweep, over the device time. Then whether
K2 at R' = 40 is bitwise the same as its five 8-column pieces. Last, each
variant KC:T (knots a chunk, columns a block) is the library built with
``-DDTO_COLUMN_KNOTS=KC -DDTO_COLUMN_BLOCK=T`` (all builds started at
once): K2 (4,1,40) × 8192's wrapper and device time, and whether its
output is bitwise the source's default build's.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from directtrajopt_tpu_torch.ops import _build, riccati_kernel  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke_timers", HERE / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

LANES, N, NS, NV = 8192, 40, 4, 1
BASE_FLAGS = list(_build.NVCC_FLAGS)


def use(variant: str | None) -> None:
    """Load (building if need be) the library of ``variant`` ("KC:T"), or
    of the source's defaults."""
    flags = []
    if variant:
        kc, t = variant.split(":")
        flags = [f"-DDTO_COLUMN_KNOTS={kc}", f"-DDTO_COLUMN_BLOCK={t}"]
    _build.NVCC_FLAGS[:] = BASE_FLAGS + flags
    _build._LIB = None
    _build.library()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="8:128,4:128,16:128,8:64,16:64")
    ap.add_argument("--build", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.build:
        use(a.build)
        return
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the GPU kernels")
    variants = [v for v in a.variants.split(",") if v]
    procs = [subprocess.Popen([sys.executable, __file__, "--build", v]) for v in variants]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    use(None)
    for name, regs, frame, smem in cs.ptxas_summary(_build.build_info().get("log", "")):
        if "resolve_columns" in name or "<4,1," in name:
            print(f"[ptxas] {name}: {regs} registers; {frame}; {smem} bytes smem", flush=True)
    dev = "cuda:0"
    s0 = np.zeros(NS)  # the cartpole's initial state is pinned
    st = cs.stage_data(51, LANES, N, dev, NS, NV, 1)
    st[2][5, 20] = -1e6
    keep = torch.ones(LANES, dtype=torch.bool, device=dev)
    keep[5] = False
    st2 = cs.stage_data(52, LANES, N, dev, NS, NV, 1)
    fac = riccati_kernel.factor_solve_plain(s0, *st2)
    cases = [("K1 (4,1,1), lane 5 indefinite", "factor_solve_grouped", keep, st,
              lambda: riccati_kernel.factor_solve(s0, *st),
              lambda: riccati_kernel.factor_solve_classed(s0, *st),
              lambda: riccati_kernel.factor_solve_plain(s0, *st),
              cs.riccati_ops(LANES, N, NS, NV, 1, factor=True), 0)]
    rhs = {}
    for R in (1, 2, 8, 40):
        r = cs.stage_data(60 + R, LANES, N, dev, NS, NV, R)[5:]
        rhs[R] = r
        ins = list(fac[:5]) + st2[3:5] + r
        kname = "resolve_" + riccati_kernel.design("resolve", NS, NV, R)
        # the design's traffic beyond the bound: the stash (p_k, kff_k)
        # written and read back, b read again in the forward sweep
        extra = LANES * R * N * (2 * (NS + NV) + NS) * 4
        cases.append((f"K2 (4,1,{R})", kname, None, ins,
                      lambda ins=ins: riccati_kernel.resolve(s0, *ins),
                      lambda ins=ins: riccati_kernel.resolve_classed(s0, *ins),
                      lambda ins=ins: riccati_kernel.resolve_plain(s0, *ins),
                      cs.riccati_ops(LANES, N, NS, NV, R, factor=False), extra))
    for name, kname, lanes, ins, kern, classed, plain, n_ops, extra in cases:
        p, k = plain(), kern()
        if lanes is not None:
            p, k = [t[lanes] for t in p], [t[lanes] for t in k]
        dev_rel, _ = cs.max_dev(p, k, True)
        outs = kern()
        b_ms, b_by = cs.time_bound(cs.nbytes(ins) + cs.nbytes(outs), n_ops)
        dms = cs.device_ms(kern, kname, 20)
        gms = cs.device_ms(classed, "_classed", 3)
        model = cs.nbytes(ins) + cs.nbytes(outs) + extra
        reach = "not measured" if dms is None else f"{b_ms / dms:.1%}"
        rate = "not measured" if dms is None else f"{model / dms / 1e6:.0f} GB/s"
        print(f"[columns] {name} x {LANES} ({kname}): wrapper {cs.cuda_ms(kern, 20):.4f} ms, back "
              f"to back {cs.cuda_ms_back_to_back(kern, 20):.4f} ms, device {dms} ms; size-class "
              f"kernel device {gms} ms; plain {cs.cuda_ms(plain, 3):.4f} ms; max relative "
              f"deviation {dev_rel:.3e}; bound {b_ms:.4f} ms ({b_by}), {reach} of it reached; "
              f"the design's traffic {model / 1e6:.1f} MB, {rate}", flush=True)
    ins = list(fac[:5]) + st2[3:5]
    whole = riccati_kernel.resolve(s0, *ins, *rhs[40])
    pieces = [riccati_kernel.resolve(s0, *ins, *(x[:, i:i + 8] for x in rhs[40]))
              for i in range(0, 40, 8)]
    same = all(torch.equal(w, torch.cat([t[j] for t in pieces], 1)) for j, w in enumerate(whole))
    print(f"[columns] K2 (4,1,40) bitwise its five 8-column pieces: {same}", flush=True)
    if any(p.wait() for p in procs):
        raise SystemExit("a variant failed to build")
    kern = cases[-1][4]
    for v in variants:
        use(v)
        out = kern()
        print(f"[columns] variant {v} (knots a chunk : columns a block), K2 (4,1,40) x {LANES}: "
              f"wrapper {cs.cuda_ms(kern, 20):.4f} ms, device "
              f"{cs.device_ms(kern, 'resolve_columns', 20)} ms; bitwise the default build's: "
              f"{all(torch.equal(x, y) for x, y in zip(out, whole))}", flush=True)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
