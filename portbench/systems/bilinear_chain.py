"""The system under test for the bilinear-chain family: its problem draws,
the port's public constructors and ``solve_batch_compact``, stage after
stage as the configuration file lists them (the seek, then the polish
warm-started from the seek's best-KKT slacks and duals; or one stage).

The draws follow the repository's seeded constructors
(``benchmarks.make_batched_bilinear_problems`` with ``_np_bilinear_rollout``,
``benchmarks.scaled_data``) in distribution: Pauli or standard-normal
generators, uniform or normal controls, a Taylor-16 rollout of the guessed
controls or a normal state guess, standard-normal chain guesses, Δt ≡ 0.1.

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
from harness.traffic import F64, _draw, call_generator

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def setup(device) -> None:
    """Build the kernel library, or load the one the checkout has built."""
    if device.type == "cuda":
        _build.library()


def pauli_generators():
    """Real 4-D Pauli representation generators Gx, Gy, Gz."""
    Gx = [[0, 0, 0, 1], [0, 0, 1, 0], [0, -1, 0, 0], [-1, 0, 0, 0]]
    Gy = [[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 0, -1], [0, 0, 1, 0]]
    Gz = [[0, 0, 1, 0], [0, 0, 0, -1], [-1, 0, 0, 0], [0, 1, 0, 0]]
    return (np.array(g, dtype=np.float64) for g in (Gx, Gy, Gz))


def state_dim(cfg: dict, traffic: dict) -> int:
    """The state's size: the configuration's, or the traffic's where the
    configuration leaves it open (the scaling family's sweep)."""
    n = cfg.get("state_dim") or traffic.get("state_dim")
    if not n:
        raise ValueError("neither the configuration nor the traffic gives state_dim")
    return int(n)


def x_init(cfg: dict, n: int) -> np.ndarray:
    """The pinned initial state: the configuration's vector, or e₀ ("e0")."""
    if cfg["x_init"] == "e0":
        return np.eye(n)[0]
    return np.asarray(cfg["x_init"], dtype=np.float64)


def rollout(Gd, Gv, x0, u, dt: float, order: int = 16):
    """x_{k+1} = exp(Δt G(u_k)) x_k by the Taylor–Horner chain, float64:
    Gd (B, n, n), Gv (B, m, n, n), x0 (n,), u (B, N, m) → (B, N, n)."""
    B, N, _ = u.shape
    xs = [torch.as_tensor(x0, dtype=F64, device=u.device).expand(B, -1)]
    for k in range(N - 1):
        A = dt * (Gd + torch.einsum("bm,bmij->bij", u[:, k], Gv))
        x = xs[-1]
        y = x
        for j in range(order, 0, -1):
            y = x + (A @ y[..., None])[..., 0] / j
        xs.append(y)
    return torch.stack(xs, dim=1)


def draw(cfg: dict, traffic: dict, seed: int, call: int, device) -> dict:
    """The problems of one call: ``data`` (x, the chain, Δt as (B, N, ·)
    float64 tensors, the initial guess) for :func:`build`, and ``problem``,
    the generators ``Gd`` (B, n, n) and ``Gv`` (B, m, n, n)."""
    g = call_generator(seed, call, device)
    B, N, m = int(traffic["lanes"]), int(cfg["N"]), int(cfg["n_drives"])
    n = state_dim(cfg, traffic)
    gens = cfg["generators"]
    if gens["kind"] == "pauli":
        Gx, Gy, Gz = pauli_generators()
        if n != 4 or m != 2:
            raise ValueError("Pauli generators need state_dim 4 and 2 drives")
        Gd = torch.as_tensor(gens["drift_scale"] * Gz, device=device).expand(B, n, n)
        Gv = torch.as_tensor(np.stack([Gx, Gy]), device=device).expand(B, m, n, n)
    elif gens["kind"] == "normal":
        Gd = _draw({"normal": gens["scale"]}, (B, n, n), g, device)
        Gv = _draw({"normal": gens["scale"]}, (B, m, n, n), g, device)
    else:
        raise ValueError(f"unknown generators {gens['kind']!r}")
    guess = traffic["guess"]
    chain = cfg["chain"]
    data = {chain[0]: _draw(guess["u"], (B, N, m), g, device)}
    for name in chain[1:]:
        data[name] = _draw(guess["chain"], (B, N, m), g, device)
    if guess["x"] == "rollout":
        x = rollout(Gd, Gv, x_init(cfg, n), data[chain[0]], float(guess["dt"]))
    else:
        x = _draw(guess["x"], (B, N, n), g, device)
    data = {"x": x, **data, "dt": torch.full((B, N, 1), float(guess["dt"]), dtype=F64,
                                             device=device)}
    return dict(data=data, problem=dict(Gd=Gd, Gv=Gv))


def guess(cfg: dict, drawn: dict) -> torch.Tensor:
    """The drawn initial guess as the answer's Z (B, N·d): each knot's x,
    the chain, then Δt."""
    d = drawn["data"]
    Z0 = torch.cat([d["x"], *(d[n] for n in cfg["chain"]), d["dt"]], dim=-1)
    return Z0.reshape(Z0.shape[0], -1)


def build(cfg: dict, drawn: dict, device):
    """The call's batch of problems through the public constructors."""
    host = {k: v.cpu().numpy() for k, v in drawn["data"].items()}
    Gd, Gv = (drawn["problem"][k].cpu().numpy() for k in ("Gd", "Gv"))
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
