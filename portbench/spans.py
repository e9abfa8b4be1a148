"""The program's own spans over one traced call of a cell: where the host
time of a lockstep pass goes, and what the host was doing while the device
waited.

    python3 portbench/spans.py --workload NAME --seed N [--out FILE]

Sets the cell up and warms it as ``run.py`` does, with the program's spans
recorded (``directtrajopt_tpu_torch.utils.profiling.record``), then runs one
call under ``torch.profiler`` as ``run.py --trace 1`` does (device activity
only), with the spans recorded again. Prints one JSON line
(``harness/host_spans.readout``):

- ``ipm.prepare_ms_per_pass``, ``ipm.kkt_ms_per_pass``,
  ``ipm.line_search_ms_per_pass``: the self time of those spans under
  ``ipm.pass`` over the call's passes (those of ``ipm.ms_per_pass``, given
  beside them); ``ipm.sync_ms_per_pass`` and ``ipm.syncs_per_pass``: the
  ``host.sync`` spans under ``ipm.pass``, the host blocked on the device;
- ``solve.structure_s``: every ``solve.structure`` span of the call;
  ``setup.library_s``: ``build.library`` in set-up;
- ``device.idle_unspanned_share``: the share of the stages' idle device
  time under no span or directly under a request's root; ``idle_by_span``:
  the idle seconds by the innermost host span open during them;
  ``setup_by_span``: set-up's and the warm-up's host seconds by span;
- ``cover_pct``: the share of the stages' seconds that ``ipm.pass``,
  ``ipm.init``, ``solve.structure`` and ``solve.result`` take;
  ``busy_outside_roots_pct``: the device's busy time in the stages' window
  outside the requests' root spans (the host's and the device's clocks
  agreeing).

The benchmark's own runs do not record the spans (``run.py`` never turns
them on). Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import run as bench  # noqa: E402
from harness import host_spans, spec, trace  # noqa: E402


def traced_spans(cell, seed: int, device) -> dict:
    """Set-up and one traced call of ``cell`` with the program's spans
    recorded; returns the readout with the device's name."""
    import torch

    from directtrajopt_tpu_torch.utils.profiling import record

    with record() as setup:
        prog = bench.Program(cell, seed, device)
    with record() as rec:
        call, prof = trace.profile_call(lambda: prog.call(0), bench.stage_bounds)
    out = host_spans.readout(call, prof, setup, rec, bench.stage_bounds(call))
    out["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(spec.benchmark(bench.ROOT), args.workload)
    line = json.dumps(dict(workload=args.workload, seed=args.seed,
                           **traced_spans(cell, args.seed, torch.device("cuda", 0))))
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
