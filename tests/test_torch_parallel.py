"""The port's ``parallel`` module: scenario-batch sharding over processes.

* A world of one (no process group, on the CPU): both sharded entry points
  return, bit for bit, what ``solve_batch`` and ``solve_batch_compact``
  return.
* Two gloo ranks, started once by ``torch.multiprocessing.spawn`` with a
  ``file://`` rendezvous (``tests/_torch_parallel_ranks.py``): (a) the
  fixture of ``tests/test_mpc_and_parallel.py::
  test_sharded_equals_unsharded_n51`` at N=12, B=8 through
  ``solve_batch_sharded``; (b) the warm, ``carry_duals`` polish of
  ``test_sharded_compact_warm_carry_equals_unsharded`` (N=8, B=16) through
  ``solve_batch_compact_sharded``. Each gathered result is bitwise the
  port's unsharded solve and the same on both ranks, and takes on every
  lane the iterations of the JAX package's sharded solve on the 8-device
  CPU mesh of ``tests/conftest.py``, its Z within 1e-7 (``golden/torch/
  sharded.npz``, made by ``golden/torch/make_sharded.py``). (c)
  ``weak_scaling`` at 1 and 2 ranks gives the JAX package's keys and a
  finite, positive efficiency (no speed bar, as in the JAX package's
  default suite); (d) a batch that the ranks do not divide raises
  ``ValueError``.
* ``index_add_ordered``, which keeps the solver's scatter-adds with a
  repeated index free of races on the card (a sharded result is bitwise
  the unsharded one there too).
"""

import os
import time

import _torch_parallel_ranks as ranks
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from directtrajopt_tpu_torch import benchmarks as tbench
from directtrajopt_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    solve_batch_compact_sharded,
    solve_batch_sharded,
)
from directtrajopt_tpu_torch.solvers.canonical import index_add_ordered
from directtrajopt_tpu_torch.solvers.solve import solve_batch, solve_batch_compact

torch.set_num_threads(1)

# the JAX package's sharded solves of (a) and (b) on its 8-device CPU mesh
# (tests/golden/torch/make_sharded.py)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch", "sharded.npz")
RECORD_KEYS = {"devices", "batch", "wall_s", "converged", "lanes_per_s", "solves_per_s",
               "efficiency"}


def test_world_of_one_equals_unsharded():
    mesh = make_mesh("cpu")
    assert mesh == Mesh((0,), torch.device("cpu"), None, "batch") and mesh.index == 0
    batch = tbench.make_batched_bilinear_problems(3, N=8, feasible_start=True, device="cpu")
    kw = dict(tol=1e-6, max_iter=8)
    assert ranks.bitwise(solve_batch_sharded(batch, mesh=mesh, **kw), solve_batch(batch, **kw))
    ckw = dict(phases=((3, None), (5, 1e-2)), chunk=2, tol=1e-6)
    assert ranks.bitwise(solve_batch_compact_sharded(batch, mesh=mesh, **ckw),
                         solve_batch_compact(batch, **ckw))


def test_make_mesh_takes_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_two_gloo_ranks(tmp_path):
    ref = np.load(GOLDEN)
    assert str(ref["options"]) == repr((ranks.SHARDED_KW, ranks.SEEK_KW, ranks.POLISH_KW))
    ctx = mp.spawn(ranks.run, args=(2, str(tmp_path / "init"), str(tmp_path)), nprocs=2,
                   join=False)
    try:
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks did not finish in 300 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    out = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for r, o in enumerate(out):
        assert o["rank_world"] == (r, 2)
        assert o["mesh"] == ((0, 1), r, "cpu")
    for case in ("a", "b"):
        assert out[0][f"{case}_bitwise"], f"({case}) differs from the unsharded solve"
        assert ranks.bitwise(out[0][case], out[1][case])
        got = out[0][case]
        assert np.array_equal(got["iterations"].numpy(), ref[f"{case}_iterations"])
        assert np.array_equal(got["converged"].numpy(), ref[f"{case}_converged"])
        assert np.max(np.abs(got["Z"].numpy() - ref[f"{case}_Z"])) < 1e-7
    assert out[0]["b"]["converged"].all()
    for o in out:
        recs = o["c"]
        assert [r["devices"] for r in recs] == [1, 2]
        assert [r["batch"] for r in recs] == [2, 4]
        assert all(set(r) == RECORD_KEYS for r in recs)
        assert all(np.isfinite(r["efficiency"]) and r["efficiency"] > 0 for r in recs)
        assert recs[0]["efficiency"] == 1.0
        assert "not divisible" in o["d"]
    assert out[0]["c"] == out[1]["c"]


def test_index_add_ordered_adds_repeats_in_order(monkeypatch):
    """The solver's scatter-adds with a repeated index (path 1's two border
    rows at one knot) add each repeat in its own pass, in the order of
    appearance: every ``index_add`` it launches has distinct indices (on
    the card, repeated ones race), and the sums are the sequential ones."""
    rng = np.random.default_rng(3)
    out = torch.as_tensor(rng.normal(size=(4, 6, 3)))
    idx = np.array([5, 1, 5, 2, 5, 1])
    src = torch.as_tensor(rng.normal(size=(4, 6, 3)) * 10.0 ** rng.integers(-8, 8, size=(4, 6, 3)))
    want = out.clone()
    for i, k in enumerate(idx):
        want[:, k] += src[:, i]
    calls = []
    orig = torch.Tensor.index_add
    monkeypatch.setattr(torch.Tensor, "index_add",
                        lambda self, dim, index, source: calls.append(index.tolist())
                        or orig(self, dim, index, source))
    got = index_add_ordered(out, 1, idx, src)
    assert torch.equal(got, want)
    assert calls == [[5, 1, 2], [5, 1], [5]]
    calls.clear()
    assert torch.equal(index_add_ordered(out, -2, np.array([3, 0]), src[:, :2]),
                       orig(out, 1, torch.tensor([3, 0]), src[:, :2]))
    assert calls == [[3, 0]]
