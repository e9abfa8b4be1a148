"""Solver callbacks.

Counterpart of ``directtrajopt_tpu/solvers/callbacks.py``. Per-iteration
hooks of :func:`~directtrajopt_tpu_torch.solvers.ipm.ipm_solve`, split by
where each runs:

* **host monitoring**: ``host_fn(info)`` once per lockstep iteration, with
  (B,) tensors of the iteration, μ, objective, KKT error and θ (and the
  primal iterate with ``include_primal``);
* **stop predicates on the device**: ``stop_fn(Z, it)`` takes Z (B, z_dim)
  and the lanes' iterations (B,) and returns (B,) booleans; each lane stops
  on its own (status 3);
* **host-interactive stop**: ``host_stop_fn(info) -> bool`` halts every
  active lane (status 3), the iterate in flight kept. Only :func:`solve`
  honours it; the batch entry points drop it with a warning;
* **rings on the device**: the last K iterates (``history_size``) and
  per-iteration optimizer-state rows (``telemetry_size``, columns
  :data:`~directtrajopt_tpu_torch.solvers.ipm.TELEMETRY_COLUMNS`);
* **best-snapshot tracking**: ``score_fn(Z)`` returns (B,) scores; the
  best-scoring iterate of each lane (and its K best with ``score_top_k``)
  is kept.

A hook that is not set costs nothing: the solve loop then runs no device
operation for it.
"""

from __future__ import annotations

import time
from functools import lru_cache
from typing import Callable

import torch

from ..module import module
from ..rollout import rollout_fidelity

__all__ = [
    "IPMCallbacks",
    "stop_iteration",
    "wall_clock_stop",
    "fidelity_stop",
    "best_fidelity_tracker",
    "telemetry",
]


@module
class IPMCallbacks:
    """Composable per-iteration hooks for :func:`ipm_solve` (all optional).

    * ``host_fn(info: dict) -> None``: called on the host each lockstep
      iteration with (B,) tensors ``iteration``, ``mu``, ``objective``,
      ``kkt_error``, ``theta``, and ``Z`` (B, z_dim) with ``include_primal``.
    * ``stop_fn(Z, iteration) -> (B,) bool``: early stop per lane, checked
      on lanes whose iteration is a multiple of ``stop_every``.
    * ``host_stop_fn(info: dict) -> bool``: polled on the host when some
      active lane's iteration is a multiple of ``host_stop_every``; True
      halts every active lane. ``info`` is ``host_fn``'s, plus
      ``start_time``: the ``time.monotonic()`` at which this solve began.
    * ``history_size``: keep a ring of each lane's last K iterates.
    * ``telemetry_size``: keep a ring of per-iteration optimizer-state rows,
      returned as ``result.ipm.history_stats`` (B, T, 8).
    * ``score_fn(Z) -> (B,)``: track each lane's best-scoring iterate;
      ``score_top_k`` > 1 also keeps its K best (unsorted) as
      ``result.ipm.topk_scores`` / ``topk_Z``.
    """

    host_fn: Callable | None = None
    include_primal: bool = False
    stop_fn: Callable | None = None
    stop_every: int = 1
    host_stop_fn: Callable | None = None
    host_stop_every: int = 8
    history_size: int = 0
    telemetry_size: int = 0
    score_fn: Callable | None = None
    score_top_k: int = 1

    def merged_with(self, other: "IPMCallbacks | None") -> "IPMCallbacks":
        if other is None:
            return self
        return IPMCallbacks(
            host_fn=self.host_fn or other.host_fn,
            include_primal=self.include_primal or other.include_primal,
            stop_fn=self.stop_fn or other.stop_fn,
            stop_every=min(self.stop_every, other.stop_every),
            host_stop_fn=self.host_stop_fn or other.host_stop_fn,
            host_stop_every=min(self.host_stop_every, other.host_stop_every),
            history_size=max(self.history_size, other.history_size),
            telemetry_size=max(self.telemetry_size, other.telemetry_size),
            score_fn=self.score_fn or other.score_fn,
            score_top_k=max(self.score_top_k, other.score_top_k),
        )


def telemetry(size: int = 128) -> IPMCallbacks:
    """Record per-iteration optimizer state on the device: a (B, size, 8)
    ring of (objective, inf_pr, inf_du, μ, KKT error, α, δ_w, θ) rows,
    returned as ``result.ipm.history_stats``. Row ``i % size`` describes
    iteration ``i`` before its step; a lane that stops on convergence also
    writes the row of its final iterate (α = 0)."""
    return IPMCallbacks(telemetry_size=size)


def wall_clock_stop(max_seconds: float, every: int = 8) -> IPMCallbacks:
    """Stop a solve once ``max_seconds`` of wall time have passed since it
    began, with status 3 and the iterate in flight kept. Each solve anchors
    its own budget (``info["start_time"]``), so solves that share this
    object do not share a clock. Also reachable as
    ``solve(prob, max_wall_time=30.0)``."""

    def over_budget(info):
        return time.monotonic() - info["start_time"] > max_seconds

    return IPMCallbacks(host_stop_fn=over_budget, host_stop_every=every)


@lru_cache(maxsize=None)
def _wall_stop_cached(max_seconds: float, every: int = 8) -> IPMCallbacks:
    """One :func:`wall_clock_stop` instance per budget, for the
    ``max_wall_time`` option (it holds no clock of its own, so sharing it
    is safe)."""
    return wall_clock_stop(max_seconds, every)


def stop_iteration(max_iterations: int) -> IPMCallbacks:
    """Stop each lane after a fixed number of iterations."""
    return IPMCallbacks(stop_fn=lambda Z, it: it >= max_iterations)


def fidelity_stop(integrator, traj_template, goal, fid_threshold: float = 0.999,
                  every: int = 1, x_name: str | None = None) -> IPMCallbacks:
    """Stop a lane when the fidelity of its rolled-out final state to
    ``goal`` ((x_dim,) or (B, x_dim)) reaches ``fid_threshold``; the rollout
    runs on the device inside the solve loop."""
    goal = torch.as_tensor(goal)

    def stop(Z, it):
        return rollout_fidelity(integrator, traj_template.from_zvec(Z),
                                goal.to(Z.device), x_name) >= fid_threshold

    return IPMCallbacks(stop_fn=stop, stop_every=every)


def best_fidelity_tracker(integrator, traj_template, goal, x_name: str | None = None,
                          top_k: int = 1) -> IPMCallbacks:
    """Track each lane's iterate(s) of best rolled-out fidelity (the K best
    with ``top_k``)."""
    goal = torch.as_tensor(goal)

    def score(Z):
        return rollout_fidelity(integrator, traj_template.from_zvec(Z),
                                goal.to(Z.device), x_name)

    return IPMCallbacks(score_fn=score, score_top_k=top_k)
