"""Scenario-batch sharding over processes.

Counterpart of ``directtrajopt_tpu/parallel/mesh.py``. The JAX package lays
the batch axis of a stacked problem over a mesh of the devices of one
controller process and runs the vmapped solve SPMD. PyTorch's idiom is one
process per device (``torchrun``, or ``torch.multiprocessing.spawn``), the
processes joined in a ``torch.distributed`` process group. Here a
:class:`Mesh` is the group's ranks and this process's device. Every rank
holds the same stacked batch, takes its contiguous lanes
(:func:`shard_batch`), solves them with the unsharded entry point, and
gathers the whole result once. Each lane's solve is independent, so the
solve itself runs no collective, as in the JAX package; every rank returns
the whole batch's result on its device (the JAX package's callers read it
with ``process_allgather``).

The backend is NCCL where each rank has a card of its own, and gloo on the
CPU or where ranks share a card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import dataclasses
import os
import time
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .. import precision
from ..module import tree_map
from ..problem import DirectTrajOptProblem
from ..solvers.options import IPMOptions
from ..solvers.solve import SolveResult, solve_batch, solve_batch_compact

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "solve_batch_sharded",
    "solve_batch_compact_sharded",
    "init_distributed",
    "weak_scaling",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """1-D mesh over the scenario-batch axis: the ranks that share a batch
    (in lane order), this process's device, the process group (None for a
    world of one) and the axis name."""

    ranks: tuple
    device: torch.device
    group: Any = None
    axis_name: str = "batch"

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This process's position on the axis: its shard."""
        return 0 if self.group is None else self.ranks.index(dist.get_rank())


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs: Any,
) -> tuple[int, int]:
    """Join the process group (one process per device) and return
    ``(rank, world size)``.

    Thin entry over :func:`torch.distributed.init_process_group`. With
    ``coordinator_address`` ("host:port", or a URL) the processes meet there
    over TCP, ``num_processes`` and ``process_id`` being the world size and
    this rank; without one they read ``torchrun``'s environment
    (``env://``) unless ``kwargs`` give an ``init_method`` (a ``file://``
    path, say). ``backend`` (in ``kwargs``) defaults to NCCL when this
    host's ranks (``LOCAL_WORLD_SIZE``, else the world) each have a card of
    their own, and to gloo otherwise. A process already in a group keeps
    it.
    """
    if not dist.is_initialized():
        kw = dict(kwargs)
        if coordinator_address is not None:
            kw.setdefault("init_method", coordinator_address if "://" in coordinator_address
                          else f"tcp://{coordinator_address}")
        kw.setdefault("init_method", "env://")
        if num_processes is not None:
            kw["world_size"] = num_processes
        if process_id is not None:
            kw["rank"] = process_id
        if "backend" not in kw:
            local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                       num_processes or os.environ.get("WORLD_SIZE", 1)))
            own_card = torch.cuda.is_available() and local <= torch.cuda.device_count()
            kw["backend"] = "nccl" if own_card else "gloo"
        kw.setdefault("timeout", timedelta(minutes=30))
        dist.init_process_group(**kw)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(devices=None, axis_name: str = "batch", *, group=None) -> Mesh:
    """1-D mesh over the scenario-batch axis: every rank of the process
    group (or of ``group``, which this rank must belong to), or a world of
    one without a group.

    ``devices``: this rank's device. None means the card,
    ``cuda:(LOCAL_RANK % device_count)`` (``LOCAL_RANK`` from ``torchrun``,
    else the rank), and raises without one; a device or its name; or a
    sequence of devices, one for each rank of the mesh. There is no
    fallback to the CPU: a caller who wants it asks for it.
    """
    if dist.is_initialized():
        group = dist.group.WORLD if group is None else group
        ranks, rank = tuple(dist.get_process_group_ranks(group)), dist.get_rank()
        if rank not in ranks:
            raise ValueError(f"rank {rank} is not in the group's ranks {ranks}")
    elif group is not None:
        raise ValueError("a group needs an initialized process group (init_distributed)")
    else:
        ranks, rank = (0,), 0
    if devices is None:
        precision.check_device(None)
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    elif isinstance(devices, (list, tuple)):
        device = torch.device(devices[ranks.index(rank)])
    else:
        device = torch.device(devices)
    return Mesh(ranks, device, group, axis_name)


def _leaves(tree) -> list:
    """The tensor leaves of ``tree``, in ``tree_map``'s order."""
    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def shard_batch(batch: Any, mesh: Mesh, axis_name: str = "batch") -> Any:
    """This rank's contiguous lanes ``[i·B/W, (i+1)·B/W)`` of a stacked
    problem, ``WarmStart`` or any tree of lane-leading tensors, on the
    rank's device (``i`` the rank's place on the mesh, ``W`` its size).
    The batch size must be divisible by the mesh size."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")
    B = _leaves(batch)[0].shape[0]
    if B % mesh.size:
        raise ValueError(f"batch size {B} is not divisible by the mesh size {mesh.size}")
    n = B // mesh.size
    lo = mesh.index * n
    return tree_map(lambda x: x[lo:lo + n].to(mesh.device), batch)


def _gather(tree, mesh: Mesh):
    """Every rank's shard of each tensor leaf, concatenated in rank order,
    on every rank, in one collective: the leaves' bytes (each padded to 8,
    so every leaf starts aligned) go in one ``all_gather`` of a uint8
    buffer (gloo takes no bool, and on gloo the buffer goes through the
    host). Every rank must hold leaves of the same shapes."""
    if mesh.size == 1:
        return tree
    leaves = _leaves(tree)
    pieces, sizes = [], []
    for x in leaves:
        b = x.contiguous().reshape(-1).view(torch.uint8)
        sizes.append(b.numel())
        pieces += [b, b.new_zeros((-b.numel()) % 8)]
    buf = torch.cat(pieces)
    if dist.get_backend(mesh.group) == "gloo":
        buf = buf.cpu()
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    full = torch.stack(parts).to(mesh.device)  # (W, bytes)
    out, off = [], 0
    for x, nb in zip(leaves, sizes):
        sl = full[:, off:off + nb].view(x.dtype)
        out.append(sl.reshape((mesh.size * x.shape[0],) + x.shape[1:]))
        off += nb + (-nb) % 8
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def solve_batch_sharded(
    batch: DirectTrajOptProblem,
    options: IPMOptions | None = None,
    *,
    mesh: Mesh | None = None,
    axis_name: str = "batch",
    backend: str = "auto",
    **kwargs: Any,
) -> SolveResult:
    """Solve a scenario batch sharded over the mesh: each rank runs
    :func:`~directtrajopt_tpu_torch.solvers.solve.solve_batch` on its lanes
    (a ``warm`` start in ``kwargs`` is sharded the same way), then one
    gather gives every rank the whole batch's result. Every rank passes the
    same batch."""
    mesh = mesh or make_mesh(axis_name=axis_name)
    if kwargs.get("warm") is not None:
        kwargs["warm"] = shard_batch(kwargs["warm"], mesh, axis_name)
    res = solve_batch(shard_batch(batch, mesh, axis_name), options, backend=backend, **kwargs)
    return _gather(res, mesh)


def solve_batch_compact_sharded(
    batch: DirectTrajOptProblem,
    options: IPMOptions | None = None,
    *,
    mesh: Mesh | None = None,
    axis_name: str = "batch",
    phases: tuple = ((14, None), (12, 1e-3), (24, 1e-3), (64, 1e-3)),
    chunk: int = 128,
    backend: str = "auto",
    warm=None,
    carry_duals: bool = False,
    **kwargs: Any,
) -> SolveResult:
    """Sharded multi-phase compacting solve: each rank runs the whole
    :func:`~directtrajopt_tpu_torch.solvers.solve.solve_batch_compact`
    schedule on its lanes (compaction stays within the rank; ``warm`` is
    sharded like the batch, ``carry_duals`` threads each lane's best-KKT
    duals through the phases), then one gather gives every rank the whole
    batch's result. Per-lane results do not depend on the chunks, so they
    are those of the unsharded solve."""
    mesh = mesh or make_mesh(axis_name=axis_name)
    if warm is not None:
        warm = shard_batch(warm, mesh, axis_name)
    res = solve_batch_compact(shard_batch(batch, mesh, axis_name), options, phases=phases,
                              chunk=chunk, backend=backend, warm=warm,
                              carry_duals=carry_duals, **kwargs)
    return _gather(res, mesh)


def weak_scaling(
    make_batch,
    device_counts=None,
    options: IPMOptions | None = None,
    *,
    repeats: int = 3,
    axis_name: str = "batch",
    devices=None,
    **kwargs: Any,
) -> list[dict]:
    """Weak-scaling measurement: solves/s on 1, 2, 4, ... ranks with a
    fixed batch per rank, through :func:`solve_batch_sharded`.

    ``make_batch(total_batch)`` returns a stacked problem of that many
    lanes, the same on every rank; its attribute ``per_device`` (default 8)
    is the lanes a rank. Each count n runs on ranks 0..n−1 of the world (a
    new group), while the others wait; ``devices`` is each rank's device,
    as :func:`make_mesh` takes it; ``kwargs`` override option fields. The
    wall time is the median of ``repeats`` timed runs after one untimed
    run, each ending once the device has finished and the group has met at
    a barrier. Returns, on every rank, one record per count: ``{"devices",
    "batch", "wall_s", "converged", "lanes_per_s", "solves_per_s",
    "efficiency"}``, efficiency against one rank's lanes/s.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    records, base_rate = [], None
    for n in device_counts:
        if n > world:
            raise ValueError(f"{n} ranks asked for, the world has {world}")
        group = None
        if dist.is_initialized():
            # every rank of the world takes part in making a group
            group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
        rec = None
        if rank < n:
            mesh = make_mesh(devices, axis_name, group=group)
            batch = make_batch(n * _per_device_hint(make_batch))
            walls = []
            for i in range(repeats + 1):
                t0 = time.perf_counter()
                res = solve_batch_sharded(batch, options, mesh=mesh, axis_name=axis_name,
                                          **kwargs)
                if mesh.device.type == "cuda":
                    torch.cuda.synchronize(mesh.device)
                if group is not None:
                    dist.barrier(group=group)
                if i:  # the first run builds and warms up
                    walls.append(time.perf_counter() - t0)
            wall = float(np.median(walls))
            B = int(res.converged.shape[0])
            conv = int(res.converged.sum())
            rec = {"devices": n, "batch": B, "wall_s": wall, "converged": conv,
                   "lanes_per_s": B / wall, "solves_per_s": conv / wall}
        if dist.is_initialized():
            box = [rec]
            dist.broadcast_object_list(box, src=0)
            rec = box[0]
        rate = rec["lanes_per_s"]
        if base_rate is None:
            base_rate = rate / n
        rec["efficiency"] = rate / (base_rate * n)
        records.append(rec)
    return records


def _per_device_hint(make_batch) -> int:
    return int(getattr(make_batch, "per_device", 8))
