"""Readings for the limits that decide ``correct``: the compared numbers of
the program as the configuration states it, and of its control, on many
seeds in one process (one set-up).

    python3 portbench/readings.py --workload NAME --seeds 11,12,13
                                  [--modes sound,answer_tf32,...] [--calls 1] [--out FILE]

Each seed runs ``--calls`` calls of the cell at its own size, and each mode
prints one JSON line: the mode, the seed, the compared numbers, the lanes
and the calls' wall seconds and passes. The control is ``answer_tf32``: the
program's answers held one precision below the float32 that the
configurations state, every float32 number rounded to TF32 (10 mantissa
bits). ``switch_tf32`` runs the program with PyTorch's TF32 switch on
instead; it changes no compared number (PERF.md), because the residuals,
Jacobians and Riccati sweeps run in full-float32 kernels and TF32 moves only
search directions that Newton's method corrects.

The faults that the control cannot show, read on the same calls:
``start_feasible``, a solve that returns its starting guess (the family's
``guess``), made feasible by the reference (its ``feasible``, which rolls
the state out from the guess's controls), with every lane flagged and the
objective reported at it: no feasibility number can see it;
``perturbed``, every answer's controls (the columns and the bound that the
reference's ``controls`` gives) moved by up to ``PERTURB`` of their bound
(uniform, drawn from the seed), made feasible again and the objective
reported at the new point;
``loose_tol``, the program with every stage's convergence tolerances
(``tol``, ``acceptable_tol``) ``LOOSEN`` times the stated ones, the step a
later change might take for speed; ``skip_polish``, where the
configuration has more than one stage, a last stage that returns its state
unchanged (the calls run without it, so its flags are the stage before's);
``half_flags``, half of each call's lanes left out (their flags cleared).
Not run by the benchmark's own runs; ``tests/test_portbench_control.py``
runs the control on the card at a small size, and the control and the
faults on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import run as bench  # noqa: E402
from harness import spec, traffic  # noqa: E402


def set_tf32(on: bool) -> None:
    """PyTorch's switch for TF32 float32 products (cuBLAS, cuDNN)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def round_tf32(x):
    """A float32 tensor rounded to TF32 (10 explicit mantissa bits, to
    nearest, ties to even), as the tensor cores round a TF32 operand."""
    import torch

    if x.dtype != torch.float32:
        return x
    b = x.view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return torch.where(torch.isfinite(x), b.view(torch.float32), x)


def tf32_answers(calls: list) -> list:
    """The calls with every float32 number of each answer (Z, the bound
    multipliers, the objective, whatever else the family returns) rounded
    to TF32: the answer of a solve held one precision below the
    configuration's."""
    return [dict(c, answer={k: round_tf32(v) for k, v in c["answer"].items()}) for c in calls]


def start_feasible(prog, calls: list, seed: int) -> list:
    """The calls as a solve that returned its starting guess would give
    them, made feasible by the reference, every lane flagged."""
    import torch

    cfg = prog.cfg
    ref = spec.reference(cfg)
    lay = ref.layout(cfg, prog.traffic)
    out = []
    for i, c in enumerate(calls):
        drawn = prog.drv.draw(cfg, prog.traffic, seed, i, prog.device)
        Z = ref.feasible(cfg, lay, prog.drv.guess(cfg, drawn), drawn["problem"])
        a = dict(c["answer"], Z=Z.cpu(), zL=torch.zeros_like(Z).cpu(),
                 zU=torch.zeros_like(Z).cpu(), objective=ref.objective(cfg, lay, Z).cpu(),
                 converged=torch.ones_like(c["answer"]["converged"]))
        out.append(dict(c, answer=a))
    return out


PERTURB = 0.05  # share of the control bound by which ``perturbed`` moves the controls


def perturbed(prog, calls: list, seed: int) -> list:
    """The calls with every answer's controls moved and the answer made
    feasible again by the reference: a feasible answer that is not the
    optimum."""
    import torch

    cfg = prog.cfg
    ref = spec.reference(cfg)
    lay = ref.layout(cfg, prog.traffic)
    cols, bound = ref.controls(cfg, lay)
    out = []
    for i, c in enumerate(calls):
        a = c["answer"]
        g = traffic.call_generator(seed, -2 - i, prog.device)  # a stream no call draws
        Z = a["Z"].to(prog.device, torch.float64).clone()
        step = 2 * torch.rand((Z.shape[0], len(cols)), generator=g, dtype=torch.float64,
                              device=prog.device) - 1
        Z[:, cols] += PERTURB * bound * step
        Z = ref.feasible(cfg, lay, Z, {k: v.to(prog.device) for k, v in c["problem"].items()})
        out.append(dict(c, answer=dict(a, Z=Z.cpu(), objective=ref.objective(cfg, lay, Z).cpu())))
    return out


def half_flags(calls: list) -> list:
    """The calls with the second half of each call's lanes left out."""
    out = []
    for c in calls:
        conv = c["answer"]["converged"].clone()
        conv[conv.numel() // 2:] = False
        out.append(dict(c, answer=dict(c["answer"], converged=conv)))
    return out


LOOSEN = 100.0  # factor on the stated tolerances in ``loose_tol``


def _calls_with(prog, cfg: dict, seed: int, calls: int) -> list:
    """New calls of the program run with ``cfg`` in place of its own."""
    own, prog.cfg = prog.cfg, cfg
    try:
        return [prog.call(i, seed=seed) for i in range(calls)]
    finally:
        prog.cfg = own


def skip_polish(prog, seed: int, calls: int) -> list:
    """New calls with the configuration's last stage left out."""
    return _calls_with(prog, dict(prog.cfg, stages=prog.cfg["stages"][:-1]), seed, calls)


def loose_tol(prog, seed: int, calls: int) -> list:
    """New calls with every stage's tolerances ``LOOSEN`` times the stated."""
    stages = [dict(st, kw={k: v * LOOSEN if k in ("tol", "acceptable_tol") else v
                           for k, v in st["kw"].items()}) for st in prog.cfg["stages"]]
    return _calls_with(prog, dict(prog.cfg, stages=stages), seed, calls)


MODES = ("sound", "answer_tf32", "switch_tf32", "start_feasible", "perturbed", "skip_polish",
         "loose_tol", "half_flags")
FROM_SOUND = {"answer_tf32": lambda prog, done, seed: tf32_answers(done),
              "start_feasible": start_feasible, "perturbed": perturbed,
              "half_flags": lambda prog, done, seed: half_flags(done)}


def readings(cell, seeds, modes, calls: int, device, emit=print):
    """One line a (seed, mode): ``sound`` the program as configured, the
    control and the faults (module docstring). Returns the lines."""
    bad = [m for m in modes if m not in MODES]
    if bad:
        raise ValueError(f"unknown modes {bad}")
    prog = bench.Program(cell, seeds[0], device)
    lines = []

    def line(mode, seed, done):
        lanes, flagged, nums = bench.judge_calls(cell, done, device)
        out = dict(mode=mode, seed=seed, numbers=nums, lanes=lanes, flagged=flagged,
                   wall_s=[c["wall_s"] for c in done], passes=[c["passes"] for c in done],
                   spans=[c["spans"] for c in done])
        lines.append(out)
        emit(json.dumps(out))

    for seed in seeds:
        if any(m == "sound" or m in FROM_SOUND for m in modes):
            done = [prog.call(i, seed=seed) for i in range(calls)]
            if "sound" in modes:
                line("sound", seed, done)
            for mode, fault in FROM_SOUND.items():
                if mode in modes:
                    line(mode, seed, fault(prog, done, seed))
        if "skip_polish" in modes and len(prog.cfg["stages"]) > 1:
            line("skip_polish", seed, skip_polish(prog, seed, calls))
        if "loose_tol" in modes:
            line("loose_tol", seed, loose_tol(prog, seed, calls))
        if "switch_tf32" in modes:
            set_tf32(True)
            try:
                done = [prog.call(i, seed=seed) for i in range(calls)]
            finally:
                set_tf32(False)
            line("switch_tf32", seed, done)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="sound,answer_tf32")
    p.add_argument("--calls", type=int, default=1)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(spec.benchmark(bench.ROOT), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    t0 = time.perf_counter()

    def emit(line):
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        readings(cell, seeds, args.modes.split(","), args.calls, torch.device("cuda", 0), emit)
    finally:
        if out:
            out.close()
    print(f"readings: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
