"""The rank processes of ``tests/test_torch_parallel.py``.

``run(rank, world, init_file, out_dir)`` joins a gloo group through a
``file://`` rendezvous, runs every multi-process case of the test on the
CPU and writes what it saw to ``out_dir/rank<r>.pt``. It imports torch and
the port only: it is the module each spawned process imports.
"""

import os

import torch

from directtrajopt_tpu_torch import benchmarks as tbench
from directtrajopt_tpu_torch.module import tree_map
from directtrajopt_tpu_torch.parallel import (
    init_distributed,
    make_mesh,
    shard_batch,
    solve_batch_compact_sharded,
    solve_batch_sharded,
    weak_scaling,
)
from directtrajopt_tpu_torch.solvers.solve import solve_batch, solve_batch_compact

# (a) tests/test_mpc_and_parallel.py::test_sharded_equals_unsharded_n51 at N=12
SHARDED_KW = dict(tol=1e-6, acceptable_tol=1e-4, acceptable_iter=1, max_iter=25)
# (b) tests/test_mpc_and_parallel.py::test_sharded_compact_warm_carry_equals_unsharded
# (here the seek is sharded too)
SEEK_KW = dict(phases=((3, None), (40, 1e-2)), chunk=2, tol=1e-6,
               hessian_approximation="gauss_newton")
POLISH_KW = dict(phases=((2, None), (12, None)), chunk=2, tol=1e-7, acceptable_tol=1e-7,
                 mu_init=1e-5, bound_push=1e-9, bound_frac=1e-9, carry_duals=True)
WEAK_KW = dict(tol=1e-6, max_iter=4)


def bitwise(a, b) -> bool:
    """Every tensor leaf of two trees equal, bit for bit."""
    eq = []
    tree_map(lambda x, y: eq.append(x.dtype == y.dtype and torch.equal(x, y)) or x, a, b)
    return bool(eq) and all(eq)


def summary(res) -> dict:
    return {"Z": res.ipm.Z, "iterations": res.iterations, "converged": res.converged}


def _weak_batch(total):
    return tbench.make_batched_bilinear_problems(total, N=6, feasible_start=True, device="cpu")


_weak_batch.per_device = 2


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    got = init_distributed(num_processes=world, process_id=rank, init_method=f"file://{init_file}")
    mesh = make_mesh("cpu")
    out = {"rank_world": got, "mesh": (mesh.ranks, mesh.index, str(mesh.device))}

    batch = tbench.make_batched_bilinear_problems(8, N=12, feasible_start=True, device="cpu")
    res = solve_batch_sharded(batch, mesh=mesh, **SHARDED_KW)
    out["a"] = summary(res)
    if rank == 0:
        out["a_bitwise"] = bitwise(res, solve_batch(batch, **SHARDED_KW))

    batch = tbench.make_batched_bilinear_problems(2 * 8, N=8, feasible_start=True, device="cpu")
    seek = solve_batch_compact_sharded(batch, mesh=mesh, **SEEK_KW)
    warm = seek.ipm.state.best_kkt_warm
    res = solve_batch_compact_sharded(seek.problem, mesh=mesh, warm=warm, **POLISH_KW)
    out["b"] = summary(res)
    if rank == 0:
        out["b_bitwise"] = bitwise(res, solve_batch_compact(seek.problem, warm=warm, **POLISH_KW))

    out["c"] = weak_scaling(_weak_batch, [1, 2], repeats=1, devices="cpu", **WEAK_KW)

    odd = tbench.make_batched_bilinear_problems(3, N=4, device="cpu")
    try:
        shard_batch(odd, mesh)
        out["d"] = None
    except ValueError as e:
        out["d"] = str(e)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
