"""Small cells for the CPU: a workload of BENCHMARK.json at a short N and a
few lanes."""

import run as bench
from harness import spec


def small_cell(workload: str, N: int = 11, lanes: int = 4):
    cell = spec.cell(spec.benchmark(bench.ROOT), workload)
    return cell._replace(config=dict(cell.config, N=N),
                         traffic=dict(cell.traffic, lanes=lanes, chunk=lanes))


def args(workload: str, seed: int = 2**31 + 11, trace: int = 0):
    return bench.parse(["--workload", workload, "--seed", str(seed), "--seconds", "0.01",
                        "--trace", str(trace)])
