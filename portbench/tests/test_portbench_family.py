"""A new family enters ``portbench/`` by new files alone: in a copy of the
harness, a test-only family (its system with ``draw``, its reference,
configuration, traffic and limits) runs end to end on the CPU, and the
faults of ``readings.py`` make it incorrect.

It is not a family of drawn generators: a two-level state transfer under
fixed generators and a target state that its configuration states, with
only the guess drawn; the target is its drawn ``problem``. Its answer
carries one key besides ``Z``, ``zL``, ``zU`` and ``objective``, the
fidelity that the program reports, which its reference reads; its
reference reads 4 lanes a block of a call's 6.
"""

import json
import os
import shutil
import subprocess
import sys

import torch

import run as bench
from harness import spec

SYSTEM = '''"""A family for the harness's tests: a two-level state transfer under fixed
generators and a target that the configuration states; only the guess is
drawn. The program is the port's bilinear integrator with the target pinned
as the final state; the answer carries the rolled-out fidelity too."""

import time

import numpy as np
import torch

from directtrajopt_tpu_torch import (BilinearIntegrator, DirectTrajOptProblem,
                                     QuadraticRegularizer, Trajectory, rollout_fidelity)
from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact
from harness.traffic import _draw, call_generator


def setup(device):
    pass


def draw(cfg, traffic, seed, call, device):
    g = call_generator(seed, call, device)
    B, N = int(traffic["lanes"]), int(cfg["N"])
    n, m = len(cfg["x_init"]), len(cfg["drives"])
    data = {"x": _draw(traffic["guess"]["x"], (B, N, n), g, device),
            "u": _draw(traffic["guess"]["u"], (B, N, m), g, device)}
    target = torch.tensor(cfg["target"], dtype=torch.float64, device=device)
    return dict(data=data, problem=dict(target=target.expand(B, n).clone()))


def guess(cfg, drawn):
    Z0 = torch.cat([drawn["data"]["x"], drawn["data"]["u"]], dim=-1)
    return Z0.reshape(Z0.shape[0], -1)


def build(cfg, drawn, device):
    host = {k: v.cpu().numpy() for k, v in drawn["data"].items()}
    traj = Trajectory.create(host, timestep=cfg["dt"], controls="u",
                             initial={"x": np.asarray(cfg["x_init"])},
                             final={"x": np.asarray(cfg["target"])},
                             bounds={"u": cfg["u_bound"]}, device=device, dtype=torch.float64)
    integ = BilinearIntegrator.create((np.asarray(cfg["drift"]), np.asarray(cfg["drives"])),
                                      "x", "u", batch=traj.B, device=device,
                                      dtype=torch.float64, method="taylor",
                                      taylor_order=cfg["taylor_order"])
    return DirectTrajOptProblem.create(traj, QuadraticRegularizer.create("u", traj, cfg["R"]),
                                       [integ])


def solve(cfg, traffic, problem, spans, max_iter=None):
    (stage,) = cfg["stages"]
    kw = dict(stage["kw"], chunk=int(traffic["chunk"]),
              phases=tuple((it if max_iter is None else min(it, max_iter), mu)
                           for it, mu in stage["kw"]["phases"]))
    w0, t0 = time.time_ns(), time.perf_counter()
    res = solve_batch_compact(problem, **kw)
    spans[stage["name"]] = dict(seconds=time.perf_counter() - t0, t_ns=(w0, time.time_ns()),
                                passes=int(res.iterations.max()))
    warm = res.ipm.state.best_kkt_warm
    fid = rollout_fidelity(res.problem.integrators[0], res.problem.trajectory,
                           torch.as_tensor(cfg["target"]).expand(problem.B, -1))
    return dict(Z=res.ipm.Z, zL=warm.zL, zU=warm.zU, objective=res.objective,
                converged=res.converged, fidelity=fid)


def counters():
    return {}
'''

REFERENCE = '''"""The plain reference of the test family: x_{k+1} = T(Δt G(u_k)) x_k with T
the Taylor polynomial of the stated order and G(u) = G_drift + Σ u_m G_m,
x_0 and x_{N-1} pinned to the configuration's start and target, |u| under
its bound, objective Σ_k ½ Δt² R ‖u_k‖². Reads the answer's reported
``fidelity`` beside Z, the multipliers and the objective."""

import math

import torch

F64 = torch.float64
NUMBERS = ("feas", "stat", "comp", "obj_gap", "fid_gap")
BLOCK = 4


class Layout:
    def __init__(self, N, n, m):
        self.N, self.n, self.m, self.d = N, n, m, n + m
        self.D = N * self.d


def layout(cfg, traffic):
    return Layout(int(cfg["N"]), len(cfg["x_init"]), len(cfg["drives"]))


def _knots(lay, Z):
    Zm = Z.reshape(Z.shape[0], lay.N, lay.d)
    return Zm[..., :lay.n], Zm[..., lay.n:]


def _steps(cfg, u):
    """T(Δt G(u_k)) for every knot but the last: (B, N-1, n, n)."""
    Gd = torch.tensor(cfg["drift"], dtype=F64, device=u.device)
    Gv = torch.tensor(cfg["drives"], dtype=F64, device=u.device)
    M = cfg["dt"] * (Gd + torch.einsum("bkm,mij->bkij", u[:, :-1], Gv))
    eye = torch.eye(M.shape[-1], dtype=F64, device=u.device)
    P = eye.expand_as(M)
    for j in range(cfg["taylor_order"], 0, -1):
        P = eye + M @ P / j
    return P


def residuals(cfg, lay, Z, target):
    x, u = _knots(lay, Z)
    dyn = x[:, 1:] - (_steps(cfg, u) @ x[:, :-1, :, None])[..., 0]
    x0 = torch.tensor(cfg["x_init"], dtype=F64, device=Z.device)
    return torch.cat([dyn.reshape(Z.shape[0], -1), x[:, 0] - x0, x[:, -1] - target], dim=1)


def objective(cfg, lay, Z):
    _, u = _knots(lay, Z)
    return 0.5 * cfg["R"] * cfg["dt"] ** 2 * (u * u).sum((1, 2))


def _rollout(cfg, lay, u):
    P = _steps(cfg, u)
    xs = [torch.tensor(cfg["x_init"], dtype=F64, device=u.device).expand(u.shape[0], -1)]
    for k in range(lay.N - 1):
        xs.append((P[:, k] @ xs[-1][..., None])[..., 0])
    return torch.stack(xs, dim=1)


def feasible(cfg, lay, Z, problem):
    """Z's controls clipped to their bound and the state rolled out from
    x_init (the target is not met)."""
    _, u = _knots(lay, Z.to(F64))
    u = u.clamp(-cfg["u_bound"], cfg["u_bound"])
    return torch.cat([_rollout(cfg, lay, u), u], dim=-1).reshape(Z.shape[0], -1)


def controls(cfg, lay):
    cols = [k * lay.d + lay.n + i for k in range(lay.N) for i in range(lay.m)]
    return cols, cfg["u_bound"]


def certificate(cfg, lay, answer, problem):
    target = problem["target"].to(F64)
    dev = target.device
    Z, zL, zU, obj, fid = (answer[k].to(device=dev, dtype=F64)
                           for k in ("Z", "zL", "zU", "objective", "fidelity"))
    B = Z.shape[0]
    if B > BLOCK:
        raise ValueError(f"{B} lanes in one block, more than BLOCK")
    u_cols = torch.tensor(controls(cfg, lay)[0], device=dev)
    bound = cfg["u_bound"]
    c = residuals(cfg, lay, Z, target)
    viol = (Z[:, u_cols].abs() - bound).clamp(min=0.0)
    feas = torch.maximum(c.abs().amax(1), viol.amax(1))

    g = torch.zeros_like(Z)
    g[:, u_cols] = cfg["R"] * cfg["dt"] ** 2 * Z[:, u_cols] - zL[:, u_cols] + zU[:, u_cols]
    J = torch.stack([torch.autograd.functional.jacobian(
        lambda z: residuals(cfg, lay, z[None], target[b:b + 1])[0], Z[b]) for b in range(B)])
    lam = torch.linalg.lstsq(J.transpose(1, 2), -g[..., None]).solution
    stat = (g + (J.transpose(1, 2) @ lam)[..., 0]).abs().amax(1)

    zl, zu, zc = zL[:, u_cols], zU[:, u_cols], Z[:, u_cols]
    comp = torch.maximum(((zc + bound) * zl).abs(), ((bound - zc) * zu).abs()).amax(1)
    comp = torch.maximum(comp, torch.clamp(torch.maximum(-zl, -zu), min=0.0).amax(1))

    xN = _rollout(cfg, lay, _knots(lay, Z)[1])[:, -1]
    overlap = (xN * target).sum(-1) ** 2 / ((xN * xN).sum(-1) * (target * target).sum(-1))
    out = dict(feas=feas, stat=stat, comp=comp, obj_gap=(obj - objective(cfg, lay, Z)).abs(),
               fid_gap=(fid - overlap).abs())
    bad = ~torch.isfinite(Z).all(1)
    return {k: torch.where(bad | ~torch.isfinite(v), math.inf, v).cpu() for k, v in out.items()}
'''

# run in the copy: one run of the cell, then one readings line a mode
RUNNER = """
import json, sys, torch
import readings
import run as bench
from harness import judge, spec
cell = spec.cell(spec.benchmark(bench.ROOT), "toy_transfer.x6")
out = bench.run(cell, bench.parse(["--workload", "toy_transfer.x6", "--seed", str(2**31 + 7),
                                   "--seconds", "0.01"]), torch.device("cpu"))
modes = ["sound", "start_feasible", "perturbed", "half_flags", "loose_tol"]
lines = readings.readings(cell, [2**31 + 9], modes, 1, torch.device("cpu"), emit=lambda l: None)
print(json.dumps(dict(run=out, modes={x["mode"]: judge.compare(x["numbers"], cell.limits)[0]
                                      for x in lines})))
"""

CONFIG = {
    "family": "toy_transfer", "reference": "toy_transfer_reference", "N": 11, "dt": 0.2,
    "x_init": [1.0, 0.0], "drift": [[0.0, 1.0], [-1.0, 0.0]],
    "drives": [[[0.0, 1.0], [1.0, 0.0]]], "taylor_order": 8, "u_bound": 1.0, "R": 1.0,
    "stages": [{"name": "solve", "kw": {"tol": 1e-8, "acceptable_tol": 1e-8,
                                        "phases": [[100, None]]}}],
}
TRAFFIC = {"lanes": 6, "chunk": 6, "guess": {"x": {"normal": 0.5}, "u": {"uniform": 0.5}}}
# set from the CPU on two seeds: the program at most feas 2.2e-10, stat 1.2e-9,
# comp 4.3e-9, obj_gap 1.4e-17, fid_gap 3.3e-16; tolerances 100 times the
# stated at least stat 3.1e-8, comp 1.3e-7; the start made feasible and the
# perturbed answer feas 0.026 and more, fid_gap 2.2e-3 and more
LIMITS = {"feas": 1e-8, "stat": 1e-8, "comp": 3e-8, "obj_gap": 1e-12, "fid_gap": 1e-12,
          "uncertified_share": 0.2}


def test_a_family_is_added_by_adding_files(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(bench.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    (here / "systems" / "toy_transfer.py").write_text(SYSTEM)
    ref_path = here / "configs" / "toy_transfer_reference.py"
    ref_path.write_text(REFERENCE)
    # a target that the dynamics reach: the rollout of a bounded pulse
    ref = spec.load_module(ref_path, "toy_transfer_reference")
    lay = ref.layout(CONFIG, TRAFFIC)
    k = torch.arange(lay.N, dtype=torch.float64)
    pulse = 0.8 * torch.sin(torch.pi * k / (lay.N - 1))[None, :, None]
    cfg = dict(CONFIG, target=ref._rollout(CONFIG, lay, pulse)[0, -1].tolist())
    (here / "configs" / "toy_transfer.json").write_text(json.dumps(cfg))
    (here / "traffic" / "x6.json").write_text(json.dumps(TRAFFIC))
    (here / "limits" / "toy_transfer.x6.json").write_text(
        json.dumps({"numbers": {k: {"limit": v} for k, v in LIMITS.items()}}))
    new = spec.benchmark(bench.ROOT)
    new["workloads"].append({"name": "toy_transfer.x6", "config": "toy_transfer",
                             "traffic": "x6", "chips": 1, "why": "a test-only family"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))

    env = dict(os.environ, PYTHONPATH=str(bench.ROOT))  # the port, beside the copy
    proc = subprocess.run([sys.executable, "-c", RUNNER], cwd=here, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    out = got["run"]
    assert out["correct"] is True and out["attempted"] == 6 and out["failed"] == 0
    assert set(out["compared"]) == set(LIMITS)
    assert out["compared"]["fid_gap"]["value"] <= LIMITS["fid_gap"]
    assert got["modes"] == {"sound": True, "start_feasible": False, "perturbed": False,
                            "half_flags": False, "loose_tol": False}
