"""The system under test for the bilinear-chain family: the port's public
constructors and ``solve_batch_compact``, stage after stage as the
configuration file lists them (the seek, then the polish warm-started from
the seek's best-KKT slacks and duals; or one stage).

The benchmark hands the program the problems it drew (host arrays, as a
user's code would) and takes back, for every lane, the answer Z, the bound
multipliers at it, the reported objective and the converged flag of the
last stage.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from directtrajopt_tpu_torch import (BilinearIntegrator, DerivativeIntegrator,
                                     DirectTrajOptProblem, QuadraticRegularizer, Trajectory)
from directtrajopt_tpu_torch.ops import _build
from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact
from harness.traffic import x_init

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def setup(device) -> None:
    """Build the kernel library, or load the one the checkout has built."""
    if device.type == "cuda":
        _build.library()


def build(cfg: dict, drawn: dict, device):
    """The call's batch of problems through the public constructors."""
    host = {k: v.cpu().numpy() for k, v in drawn["data"].items()}
    Gd, Gv = drawn["Gd"].cpu().numpy(), drawn["Gv"].cpu().numpy()
    B, m = host["x"].shape[0], int(cfg["n_drives"])
    chain, dtype = cfg["chain"], DTYPES[cfg["dtype"]]
    u = chain[0]
    traj = Trajectory.create(
        host, timestep="dt", controls=(chain[-1], "dt"),
        initial={"x": x_init(cfg, host["x"].shape[-1]), u: np.zeros(m)},
        final={u: np.zeros(m)}, goal=cfg.get("goal"),
        bounds={u: cfg["u_bound"], "dt": (cfg["dt"]["lb"], cfg["dt"]["ub"])},
        device=device, dtype=dtype)
    integ = cfg["integrator"]
    integrators = [BilinearIntegrator.create((Gd, Gv), "x", u, batch=B, device=device,
                                             dtype=dtype, method=integ["method"],
                                             taylor_order=integ.get("taylor_order", 12))]
    integrators += [DerivativeIntegrator.create(a, b) for a, b in zip(chain[:-1], chain[1:])]
    terms = [QuadraticRegularizer.create(name, traj, w) for name, w in cfg["regularize"].items()]
    obj = terms[0]
    for t in terms[1:]:
        obj = obj + t
    return DirectTrajOptProblem.create(traj, obj, integrators)


def _stage_kw(stage: dict, traffic: dict, max_iter: int | None) -> dict:
    kw = dict(stage["kw"], chunk=int(traffic["chunk"]))
    kw["phases"] = tuple((int(it) if max_iter is None else min(int(it), max_iter), mu)
                         for it, mu in kw["phases"])
    return kw


def solve(cfg: dict, traffic: dict, problem, spans: dict, max_iter: int | None = None):
    """Every stage on ``problem``; ``spans`` receives each stage's wall
    seconds (ending once the device has finished), its start and end on the
    wall clock (ns, ``t_ns``) and its lockstep passes. ``max_iter`` caps
    every phase (the warm-up). Returns the answer."""
    res = None
    for stage in cfg["stages"]:
        kw = _stage_kw(stage, traffic, max_iter)
        w0, t0 = time.time_ns(), time.perf_counter()
        with torch.profiler.record_function(f"stage:{stage['name']}"):
            if stage.get("warm_start"):
                res = solve_batch_compact(res.problem, warm=res.ipm.state.best_kkt_warm, **kw)
            else:
                res = solve_batch_compact(problem, **kw)
            if res.converged.is_cuda:
                torch.cuda.synchronize(res.converged.device)
        spans[stage["name"]] = dict(seconds=time.perf_counter() - t0, t_ns=(w0, time.time_ns()),
                                    passes=int(res.iterations.max()))
    warm = res.ipm.state.best_kkt_warm
    return dict(Z=res.ipm.Z, zL=warm.zL, zU=warm.zU, objective=res.objective,
                converged=res.converged)


def counters() -> dict:
    """The program's launch counters, copied."""
    return dict(LAUNCHES=dict(_build.LAUNCHES), PLAIN_CALLS=dict(_build.PLAIN_CALLS),
                INSTANCES=dict(_build.INSTANCES))
