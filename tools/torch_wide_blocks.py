"""Time the wide K1/K2 (``factor_solve_wide``, ``resolve_wide``) at several
block sizes on one GPU.

    python3 tools/torch_wide_blocks.py [--variants 128,32,...]

Each variant T builds the kernel library with ``-DDTO_WIDE_THREADS=T``
(lanes a block; the source's default is 32), all variants' builds started
at once. Then, for each, on seeded well-conditioned stage data
(``chip_smoke.stage_data``) at N=51: K1 at (n_s, n_v, R) = (18, 3, 3) on
128 and 1024 lanes and (24, 24, 8) on 256, K2 at (18, 3, 2) on 128 lanes. It prints the wrapper time (CUDA events,
median), the plain version's, and the kernel's max relative deviation from
the plain version (``chip_smoke.max_dev``).
"""
import argparse
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

BASE_FLAGS = list(_build.NVCC_FLAGS)


def use(variant: str) -> None:
    """Load (building if need be) the library of ``variant`` (T)."""
    _build.NVCC_FLAGS[:] = BASE_FLAGS + [f"-DDTO_WIDE_THREADS={variant}"]
    _build._LIB = None
    _build.library()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="128,64,32,16,8")
    ap.add_argument("--build", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.build:
        use(a.build)
        return
    variants = a.variants.split(",")
    procs = [subprocess.Popen([sys.executable, __file__, "--build", v]) for v in variants]
    if any(p.wait() for p in procs):
        raise SystemExit("a variant failed to build")
    dev = "cuda:0"
    N = 51
    cases = []
    for lanes, shape, reps in ((128, (18, 3, 3), 5), (1024, (18, 3, 3), 3),
                               (256, (24, 24, 8), 3)):
        s0 = cs.np.arange(shape[0]) >= 2
        st = cs.stage_data(11, lanes, N, dev, *shape)
        cases.append((f"K1 {shape} x {lanes}", reps,
                      lambda s0=s0, st=st: riccati_kernel.factor_solve(s0, *st),
                      lambda s0=s0, st=st: riccati_kernel.factor_solve_plain(s0, *st)))
    s0 = cs.np.arange(18) >= 2
    st = cs.stage_data(12, 128, N, dev, 18, 3, 2)
    fac = riccati_kernel.factor_solve_plain(s0, *st)
    cases.append(("K2 (18, 3, 2) x 128", 5,
                  lambda: riccati_kernel.resolve(s0, *fac[:5], *st[3:]),
                  lambda: riccati_kernel.resolve_plain(s0, *fac[:5], *st[3:])))
    plain_ms = {name: cs.cuda_ms(plain, reps) for name, reps, _, plain in cases}
    for v in variants:
        use(v)
        for name, reps, kern, plain in cases:
            dev_rel, _ = cs.max_dev(plain(), kern(), True)
            print(f"[wide] {v} lanes a block, {name}: kernel "
                  f"{cs.cuda_ms(kern, reps):.4f} ms, plain {plain_ms[name]:.4f} ms, max relative "
                  f"deviation {dev_rel:.3e}", flush=True)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
