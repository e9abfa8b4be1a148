"""Time the grouped K1/K2 beyond n_s = 8 on one GPU.

    python3 tools/torch_grouped_wide.py

``factor_solve_grouped`` / ``resolve_grouped`` at the scaling family's
shapes (n_s 10 and 18) serve a lane with a group of G threads, the least
power of two ≥ n_s (16 and 32), thread gi owning row gi of P and the
threads past n_s owning none (``GroupLayout`` in
``directtrajopt_tpu_torch/csrc/riccati_kernel.cu``). The script loads the
library (where it builds it, it prints these kernels' registers and stack
frames from ``-Xptxas -v``), then, on seeded well-conditioned stage data
(``chip_smoke.stage_data``) at N=51 with one lane indefinite, times K1 at
(10,3,3) and (18,3,3) and K2 at (10,3,2) and (18,3,2) on 128 lanes (path
7's chunk) and 1024. Per row: the wrapper time (CUDA events, median), back
to back, the device time per launch (``torch.profiler``), the plain
version's time and the max relative deviation from it on the lanes off the
indefinite one.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
import torch  # noqa: E402

from directtrajopt_tpu_torch.ops import _build, riccati_kernel  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke_timers", HERE / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the GPU kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    _build.library()
    for name, regs, frame, _ in cs.ptxas_summary(_build.build_info().get("log", "")):
        if "_grouped<1" in name:
            print(f"[grouped] {name} {regs} registers; {frame}", flush=True)
    dev = "cuda:0"
    N = 51
    cases = []
    for lanes in (128, 1024):
        for ns in (10, 18):
            s0 = cs.np.arange(ns) >= 2
            st = cs.stage_data(21, lanes, N, dev, ns, 3, 3)
            st[2][5, 20] = -1e6 * torch.eye(3, device=dev)
            keep = torch.ones(lanes, dtype=torch.bool, device=dev)
            keep[5] = False
            cases.append((f"K1 ({ns},3,3) x {lanes}", f"factor_solve_grouped<{ns},3,3>", keep,
                          lambda s0=s0, st=st: riccati_kernel.factor_solve(s0, *st),
                          lambda s0=s0, st=st: riccati_kernel.factor_solve_plain(s0, *st)))
            st = cs.stage_data(22, lanes, N, dev, ns, 3, 2)
            fac = riccati_kernel.factor_solve_plain(s0, *st)
            cases.append((f"K2 ({ns},3,2) x {lanes}", f"resolve_grouped<{ns},3,2>", None,
                          lambda s0=s0, st=st, fac=fac: riccati_kernel.resolve(
                              s0, *fac[:5], *st[3:]),
                          lambda s0=s0, st=st, fac=fac: riccati_kernel.resolve_plain(
                              s0, *fac[:5], *st[3:])))
    for name, kname, keep, kern, plain in cases:
        p, k = plain(), kern()
        if keep is not None:
            p, k = [t[keep] for t in p], [t[keep] for t in k]
        dev_rel, _ = cs.max_dev(p, k, True)
        dms = cs.device_ms(kern, "_grouped", 20)
        print(f"[grouped] {name} ({kname}): wrapper "
              f"{cs.cuda_ms(kern, 20):.4f} ms, back to back "
              f"{cs.cuda_ms_back_to_back(kern, 20):.4f} ms, device "
              f"{'not measured' if dms is None else f'{dms:.4f}'} ms; plain "
              f"{cs.cuda_ms(plain, 5):.4f} ms; max relative deviation {dev_rel:.3e}", flush=True)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
