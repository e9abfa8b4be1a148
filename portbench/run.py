"""The benchmark of directtrajopt_tpu_torch on NVIDIA GPUs.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell ``NAME`` of ``BENCHMARK.json`` names
a configuration and a traffic mix; their files, the configuration's family
and reference, the per-layer metrics' readers and the cell's limits are
found by name (``harness/spec.py``, which states what a family and a
reference give). This file names no problem's data: the family draws each
call's problems and solves them, and the reference reads each lane's
answer and problem whole.

A run builds (or loads) the port's kernels and warms every shape of the
cell with one short call, then:

- ``--trace 0``: calls the family's solve back to back, each call on
  fresh problems drawn from the seed and the call's index, for ``S``
  seconds; the call running when they end runs to its end and counts.
  Prints the end-to-end metrics: certified lanes a second over the time from
  the window's start to the last call's end, the peak of allocated device
  memory in the window, and the set-up time from process start to the first
  timed call.
- ``--trace 1``: one whole call under ``torch.profiler`` with the calls
  into the kernel layer recorded; prints the per-layer metrics and the
  breakdown of device time and idle gaps.

Both then free the program's state and judge every lane the calls flagged
with the configuration's plain float64 reference, in blocks of lanes; the
last line of standard output is one JSON object, whose last key
``compared`` gives each number that decided ``correct`` beside its limit
(also the last lines of standard error). Exits 2 without a CUDA device or
with fewer than the cell asks for, and 3 if a module of the JAX stack was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import guard, judge, spec, trace  # noqa: E402

GIB = float(1 << 30)
REFERENCE_BLOCK = 1024  # lanes the reference reads at once, where it states no BLOCK


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_answer(ans: dict, drawn: dict):
    """What the reference reads of a call, on the host: every tensor the
    family's solve returned, and the drawn problem's."""
    return ({k: v.detach().cpu() for k, v in ans.items()},
            {k: v.detach().cpu() for k, v in drawn["problem"].items()})


class Program:
    """The cell's system under test, set up and warmed."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic = cell.config, cell.traffic
        self.drv = spec.system(self.cfg)
        self.drv.setup(device)
        t0 = time.perf_counter()
        # every shape of the cell, at every phase, one pass each
        drawn = self.drv.draw(self.cfg, self.traffic, seed, -1, device)
        self.drv.solve(self.cfg, self.traffic, self.drv.build(self.cfg, drawn, device), {},
                       max_iter=1)
        _sync(device)
        self.warmup_s = time.perf_counter() - t0

    def call(self, index: int, seed: int | None = None) -> dict:
        """One call on fresh problems (drawn from the run's seed, or
        ``seed``): its spans, and its answer and problem on the host."""
        drawn = self.drv.draw(self.cfg, self.traffic, self.seed if seed is None else seed,
                              index, self.device)
        spans: dict = {}
        t0 = time.perf_counter()
        ans = self.drv.solve(self.cfg, self.traffic,
                             self.drv.build(self.cfg, drawn, self.device), spans)
        wall = time.perf_counter() - t0
        answer, problem = _host_answer(ans, drawn)
        return dict(spans=spans, wall_s=wall, passes=sum(s["passes"] for s in spans.values()),
                    answer=answer, problem=problem)


def window(prog: Program, seconds: float):
    """Closed loop of calls for ``seconds``; the last one runs to its end."""
    import torch

    if prog.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(prog.device)
    calls, t0 = [], time.perf_counter()
    while True:
        calls.append(prog.call(len(calls)))
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(prog.device) if prog.device.type == "cuda" else 0
    return calls, elapsed, peak


def stage_bounds(call: dict):
    """The first stage's start and the last one's end on the wall clock."""
    spans = call["spans"].values()
    return min(s["t_ns"][0] for s in spans), max(s["t_ns"][1] for s in spans)


def traced(prog: Program, metrics: list):
    """One whole call after the warm-up, profiled, with the kernel layer's
    calls recorded; returns the calls, the per-layer values, the profile and
    the peak memory."""
    import torch

    readers = {m["name"]: spec.metric_reader(m["name"]) for m in metrics}
    targets = [t for _, data in readers.values() for t in data.get("wrap", ())]
    if prog.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(prog.device)
    before = prog.drv.counters()
    with trace.record_calls(targets) as kcalls:
        call, prof = trace.profile_call(lambda: prog.call(0), stage_bounds)
    after = prog.drv.counters()
    peak = torch.cuda.max_memory_allocated(prog.device) if prog.device.type == "cuda" else 0
    counters = {g: {k: after[g].get(k, 0) - before[g].get(k, 0) for k in after[g]}
                for g in after}
    view = dict(cfg=prog.cfg, traffic=prog.traffic, call=call, profile=prof,
                kernel_calls=list(kcalls), counters=counters,
                setup={"warmup_s": prog.warmup_s})
    values = {}
    for name, (mod, data) in readers.items():
        v = mod.read(SimpleNamespace(**view, data=data))
        if v is not None:
            values[name] = v
    return [call], values, prof, peak


def judge_calls(cell, calls: list, device):
    """Every flagged lane of every call through the plain reference, in
    blocks of the reference's ``BLOCK`` lanes (``REFERENCE_BLOCK`` where it
    states none), each block's answer and problem handed over whole;
    returns the counts and the compared numbers."""
    import torch

    ref = spec.reference(cell.config)
    lay = ref.layout(cell.config, cell.traffic)
    block = int(getattr(ref, "BLOCK", REFERENCE_BLOCK))
    lanes = flagged = 0
    certs = []
    with torch.no_grad():
        for c in calls:
            conv = c["answer"]["converged"]
            lanes += conv.numel()
            idx = torch.nonzero(conv)[:, 0]
            flagged += idx.numel()
            for b0 in range(0, idx.numel(), block):
                i = idx[b0:b0 + block]
                answer = {k: v[i].to(device) for k, v in c["answer"].items()}
                problem = {k: v[i].to(device) for k, v in c["problem"].items()}
                certs.append(ref.certificate(cell.config, lay, answer, problem))
    return lanes, flagged, judge.numbers(lanes, flagged, certs, ref.NUMBERS)


def _num(v):
    return v if isinstance(v, (int, bool)) or math.isfinite(v) else None


def run(cell, args, device) -> dict:
    """One run of ``cell`` on ``device`` (a CUDA device, or the CPU in the
    harness's own tests); returns the result line as a dict."""
    import torch

    prog = Program(cell, args.seed, device)
    _sync(device)
    setup_s = time.perf_counter() - T_START
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell.workload["chips"])}
    breakdown = None
    if args.trace:
        calls, values, prof, peak = traced(prog, cell.per_layer)
        dev.update(busy_s=prof.busy_s, window_s=prof.window_s)
        print(f"portbench: traced window {prof.window_s:.3f} s, bounded by the "
              f"{prof.bounded_by}", file=sys.stderr)
        breakdown = {"device_ops": [[n, s] for n, s in prof.device_ops[:10]],
                     "idle_gaps": [[n, s] for n, s in prof.idle_gaps[:10]]}
    else:
        calls, elapsed, peak = window(prog, args.seconds)
        certified = sum(int(c["answer"]["converged"].sum()) for c in calls)
        values = {"certified_solves_per_s": certified / elapsed, "peak_device_gib": peak / GIB,
                  "setup_s": setup_s}
    dev["memory_peak_bytes"] = int(peak)
    t_measured = time.perf_counter()
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    lanes, flagged, nums = judge_calls(cell, calls, device)
    print(f"portbench: setup {setup_s:.3f} s, measured {t_measured - T_START - setup_s:.3f} s "
          f"({len(calls)} calls), reference {time.perf_counter() - t_measured:.3f} s",
          file=sys.stderr)
    correct, compared = judge.compare(nums, cell.limits)
    for name in sorted(set(nums) - set(compared)):
        print(f"reading {name} {nums[name]!r} (not compared)", file=sys.stderr)
    metrics = {n: {"value": values[n], "unit": units[n]} for n in units if n in values}
    out = {"correct": bool(correct), "attempted": lanes, "failed": lanes - flagged,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                       for k, v in compared.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.cell(spec.benchmark(ROOT), args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(cell, args, torch.device("cuda", 0))
    bad = guard.forbidden_modules()
    if bad:
        print(f"portbench: modules of the JAX stack were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
