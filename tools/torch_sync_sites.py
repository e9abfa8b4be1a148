"""List on the GPU every operation of a benchmark call that synchronizes
the host with the card, by where the port calls it.

    python3 tools/torch_sync_sites.py [--workloads W1,W2] [--N 11] [--lanes 64]

Each cell of ``BENCHMARK.json`` (by default all) is set up at a short N
and a few lanes, then one call runs under ``torch.cuda``'s sync debug
mode, which warns at each synchronizing operation: a blocking read
(``bool``, ``float``, ``.cpu()``), a library call that reads its own error
flag (``torch.linalg.solve``), and a copy from pageable host memory to the
card (``torch.as_tensor(numpy_array, device=...)``, which waits for the
card's queue). Prints one JSON line a cell: the call's passes and each
site's count, the innermost four frames of the port or the benchmark,
innermost first. The sites with a ``host.sync`` span are the blocking
reads; the others show in a traced run as idle time under the span that
calls them.
"""
import argparse
import collections
import json
import sys
import traceback
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def sites_of(call) -> collections.Counter:
    """Run ``call()`` under sync debug mode; count its synchronizing
    operations by site."""
    sites: collections.Counter = collections.Counter()

    def show(message, *args, **kwargs):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "directtrajopt_tpu_torch" in f.filename or "portbench" in f.filename]
        sites[" < ".join(f"{Path(f.filename).name}:{f.lineno}:{f.name}"
                         for f in reversed(frames[-4:]))] += 1

    with warnings.catch_warnings():  # restores showwarning
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sites


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", default="")
    ap.add_argument("--N", type=int, default=11)
    ap.add_argument("--lanes", type=int, default=64)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this tool measures the card: no CUDA device")
    sys.path[:0] = [str(ROOT), str(ROOT / "portbench")]
    import run as bench
    from harness import spec

    b = spec.benchmark(ROOT)
    names = a.workloads.split(",") if a.workloads else [w["name"] for w in b["workloads"]]
    dev = torch.device("cuda", 0)
    for w in names:
        cell = spec.cell(b, w)
        cell = cell._replace(config=dict(cell.config, N=a.N),
                             traffic=dict(cell.traffic, lanes=a.lanes, chunk=a.lanes))
        prog = bench.Program(cell, 2**31 + 7, dev)
        torch.cuda.synchronize(dev)
        c, sites = sites_of(lambda: prog.call(0))
        print(json.dumps({"cell": w, "N": a.N, "lanes": a.lanes, "passes": c["passes"],
                          "sites": sites.most_common()}), flush=True)


if __name__ == "__main__":
    main()
