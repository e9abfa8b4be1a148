"""Check on the GPU that a lane's result does not depend on its place in
the batch, as compaction and sharding need (a lane lands elsewhere in its
chunk, or in another process's shard).

    python3 tools/torch_lane_place.py [--root DIR]

DIR (default: this checkout) is the tree whose package is run: give the
parent's tree unpacked into a directory ``.gitignore`` lists to see it
before a change.

1. Row sums: 256 random float32 rows of a length (127, 128, 129, 561 — path
   1's knot-vector width —, 562, 564), summed as they lie and after a
   shuffle of the rows, by ``Tensor.sum(-1)`` and by the port's
   ``precision.lane_sum`` (where the package has it); the count of rows
   whose two sums differ. On the
   card a sum over a contiguous row of 128 or more elements is split at
   the row's alignment to the reduction's vector width, so a row length
   that is not a multiple of 4 makes a row's sum depend on its place.
2. The solver: path 1's seek (its options, one phase of 60 iterations) on
   lanes 0-255 of path 1's batch, and on the same lanes rolled by one
   place; the count of lanes whose Z or iterations differ.
"""
import argparse
import sys
from pathlib import Path

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    root = Path(ap.parse_args().root).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("this tool measures the card: no CUDA device")
    sys.path.insert(0, str(root))
    from directtrajopt_tpu_torch import benchmarks, precision
    from directtrajopt_tpu_torch.module import tree_take
    from directtrajopt_tpu_torch.solvers.solve import cast_problem, solve_batch_compact

    print(f"package: {Path(benchmarks.__file__).parent}", flush=True)

    dev = torch.device("cuda:0")
    print(torch.cuda.get_device_name(0), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for n in (127, 128, 129, 561, 562, 564):
        x = torch.randn(256, n, device=dev, generator=gen) * torch.logspace(-3, 3, n, device=dev)
        perm = torch.randperm(256, device=dev, generator=gen)
        y = x[perm].contiguous()
        sums = [("Tensor.sum", lambda t: t.sum(-1))]
        if hasattr(precision, "lane_sum"):
            sums.append(("lane_sum", precision.lane_sum))
        diff = {name: int((f(x)[perm] != f(y)).sum()) for name, f in sums}
        print(f"[rows] length {n}: rows whose sum moves with their place {diff}", flush=True)

    cfg = benchmarks.headline_config()
    full = cast_problem(benchmarks.make_batched_bilinear_problems(
        cfg["batch"], N=cfg["N"], feasible_start=True, taylor_order=cfg["taylor_order"],
        device=dev, dtype=torch.float64), torch.float32)
    lanes = 256
    idx = torch.arange(lanes, device=dev)
    rolled = torch.roll(idx, 1)  # place j holds lane rolled[j]
    back = torch.argsort(rolled)
    kw = dict(cfg["phase1_kw"], phases=((60, None),), chunk=lanes)
    a = solve_batch_compact(tree_take(full, idx), **kw)
    b = solve_batch_compact(tree_take(full, rolled), **kw)
    dz = (a.problem.trajectory.to_zvec() != b.problem.trajectory.to_zvec()[back]).any(1)
    dit = a.iterations != b.iterations[back]
    print(f"[solver] the seek on {lanes} lanes rolled by one place: Z differs on "
          f"{int(dz.sum())} lanes, iterations on {int(dit.sum())}", flush=True)


if __name__ == "__main__":
    main()
