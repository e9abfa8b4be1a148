from .mesh import (
    Mesh,
    init_distributed,
    make_mesh,
    shard_batch,
    solve_batch_compact_sharded,
    solve_batch_sharded,
    weak_scaling,
)

__all__ = [
    "Mesh",
    "init_distributed",
    "make_mesh",
    "shard_batch",
    "solve_batch_compact_sharded",
    "solve_batch_sharded",
    "weak_scaling",
]
