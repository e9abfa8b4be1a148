"""Time the PyTorch port's grouped K1 kernel at several ring depths, on one GPU.

    python3 tools/torch_k1_rings.py            # depths 2 3 4
    python3 tools/torch_k1_rings.py 2 4        # chosen depths

``factor_solve_grouped`` (``directtrajopt_tpu_torch/csrc/riccati_kernel.cu``)
prefetches each knot's blocks into a ring of ``kStages`` shared-memory
buffers. For each depth this script builds the kernels with that constant
into its own directory under ``directtrajopt_tpu_torch/_build/``, checks K1
against its plain PyTorch version, and times it (CUDA events, median of
50 wrapper calls) on the rows ``chip_smoke.py`` checks: (n_s, n_v, R) =
(8,3,3) at 256 and 8192 lanes, and (2,1,3) at 8192 lanes on inputs captured
from the state-constrained family's own solve. The first depth is timed
again at the end, to show the spread between two timings of one build.
Last, each row's outputs are compared with those of the size-class kernel
on the same inputs (max |difference| over every output).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from directtrajopt_tpu_torch import benchmarks  # noqa: E402
from directtrajopt_tpu_torch.ops import _build  # noqa: E402
from directtrajopt_tpu_torch.ops import riccati_kernel as rk  # noqa: E402
from directtrajopt_tpu_torch.solvers.solve import cast_problem, solve  # noqa: E402

STAGES_LINE = "constexpr int kStages = 2;"
BUILD_ROOT = _build.BUILD_DIR


def build(depth: int) -> None:
    """Load the kernel library built with a ring of ``depth`` buffers."""
    vdir = BUILD_ROOT / f"rings_{depth}"
    (vdir / "csrc").mkdir(parents=True, exist_ok=True)
    for f in (ROOT / "directtrajopt_tpu_torch" / "csrc").glob("*.cu*"):
        text = f.read_text()
        if f.name == "riccati_common.cuh":
            if STAGES_LINE not in text:
                raise SystemExit(f"'{STAGES_LINE}' not found in {f}")
            text = text.replace(STAGES_LINE, f"constexpr int kStages = {depth};")
        (vdir / "csrc" / f.name).write_text(text)
    _build._LIB = None
    _build.SRC_DIR = vdir / "csrc"
    _build.BUILD_DIR = vdir
    _build.library()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the GPU kernel")
    depths = [int(a) for a in sys.argv[1:]] or [2, 3, 4]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    dev = torch.device("cuda:0")
    N = 51
    s0 = np.arange(8) >= 2
    rows = [("(8,3,3) B=256", [s0] + cs.stage_data(0, 256, N, dev), None)]
    st = cs.stage_data(0, 8192, N, dev)
    st[2][77, 20] = -1e6 * torch.eye(3, device=dev)
    rows.append(("(8,3,3) B=8192", [s0] + st, None))
    sc = benchmarks.state_constrained_config()
    prob = cast_problem(benchmarks.make_batched_state_constrained_problems(
        sc["batch"], N=sc["N"], device=dev), torch.float32)
    kw = {k: v for k, v in sc["solve_kw"].items() if k not in ("phases", "chunk")}
    with cs.Capture(rk, "factor_solve", 1) as cap:
        solve(prob, max_iter=1, **kw)
    args = list(cap.calls[0])
    rows.append(("(2,1,3) B=8192 path-2 inputs", args,
                 cs.well_conditioned(rk.factor_solve_plain, args, tol=1e-6)))
    refs = [rk.factor_solve_plain(*a) for _, a, _ in rows]
    for depth in depths + depths[:1]:
        build(depth)
        cells = []
        for (label, a, lanes), ref in zip(rows, refs):
            out = rk.factor_solve(*a)
            if lanes is not None:
                ref, out = [t[lanes] for t in ref], [t[lanes] for t in out]
            dev_rel, _ = cs.max_dev(ref, out, rel=True)
            if dev_rel > 5e-6 or not bool((ref[5] == out[5]).all()):
                raise SystemExit(f"depth {depth}, {label}: disagrees with the plain version "
                                 f"({dev_rel:.2e})")
            cells.append(f"{label} {cs.cuda_ms(lambda: rk.factor_solve(*a), reps=50):.4f} ms")
        print(f"ring of {depth}: " + "; ".join(cells), flush=True)
    grouped = [rk.factor_solve(*a) for _, a, _ in rows]
    classed = [rk.factor_solve_classed(*a) for _, a, _ in rows]
    for (label, _, _), g, o in zip(rows, grouped, classed):
        diff = 0.0
        for x, y in zip(g, o):
            d = (x.double() - y.double()).abs()
            d = torch.where(torch.isnan(x) & torch.isnan(y), 0.0, d)  # NaN in both: equal
            diff = max(diff, float(d.nan_to_num(float("inf")).max()) if d.numel() else 0.0)
        print(f"{label}: grouped vs size-class kernel, max |difference| {diff:.3e}", flush=True)


if __name__ == "__main__":
    main()
