"""Plain float64 reference of the bilinear-chain family: ``bilinear_n51`` and
``scaled_n51`` (DirectTrajOpt.jl ``benchmark/problem_utils.jl``).

The problem, as the configuration file states it. Knot k = 0 … N−1 holds x
(state_dim), the chain c_0 = u, c_1, … (n_drives each) and Δt_k:

    min   Σ_k ½ Δt_k² Σ_c w_c ‖c_k‖²                 (c in ``regularize``)
    s.t.  x_{k+1} = Φ(Δt_k G(u_k)) x_k,   G(u) = G_drift + Σ_m u_m G_drive_m
          c_{j,k+1} = c_{j,k} + Δt_k c_{j+1,k}        (each link of the chain)
          x_0 = x_init (a vector, or e₀),  u_0 = u_{N−1} = 0
          |u_k| ≤ u_bound (k = 1 … N−2),  dt_lb ≤ Δt_k ≤ dt_ub

Φ is the exponential (``"exp"``) or its Taylor polynomial of the stated
order (``"taylor"``). The reference judges a solver's answer by the
first-order optimality conditions at it, each in float64: the equality and
bound residuals (``feas``), the stationarity residual of the Lagrangian with
the solver's bound multipliers and the least-squares equality multipliers
(``stat``, the least squares taken over the Jacobian's rows scaled to unit
length, which leaves the residual as it is and keeps it finite where the
state grows large; the solver's own equality multipliers are not read),
complementarity of the bound multipliers (``comp``), the gap between the
objective the solver reported and the objective at its answer
(``obj_gap``), and the gap between the objective at its answer and the
problem's optimum (``opt_gap``, :func:`optimum`). It imports nothing of the
program.

What the harness reads of it: :func:`layout` from the configuration and
the traffic, :func:`certificate` of a block of lanes, given the answer
(``Z``, ``zL``, ``zU``, ``objective``) and the drawn problem (the
generators ``Gd``, ``Gv``) as two dicts of lane-first tensors, with
``NUMBERS``, the names of its per-lane numbers; for the faults of
``readings.py``, :func:`feasible`, :func:`objective` and :func:`controls`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["NUMBERS", "Layout", "layout", "pins", "bounds", "step_matrix", "residuals",
           "objective", "optimum", "gradient", "jacobian", "feasible", "controls",
           "certificate"]

F64 = torch.float64
NUMBERS = ("feas", "stat", "comp", "obj_gap", "opt_gap")


class Layout:
    """Column offsets of one knot: x, the chain, then Δt."""

    def __init__(self, N: int, state_dim: int, n_drives: int, chain):
        self.N, self.n, self.m, self.chain = N, state_dim, n_drives, tuple(chain)
        self.offsets = {"x": 0}
        off = state_dim
        for name in self.chain:
            self.offsets[name] = off
            off += n_drives
        self.offsets["dt"] = off
        self.d = off + 1
        self.D = N * self.d
        self.n_eq = (N - 1) * (state_dim + n_drives * (len(self.chain) - 1))

    def col(self, name: str, k: int, i: int = 0) -> int:
        return k * self.d + self.offsets[name] + i

    def cols(self, name: str, k: int) -> slice:
        w = 1 if name == "dt" else self.n if name == "x" else self.m
        return slice(self.col(name, k), self.col(name, k) + w)


def layout(cfg: dict, traffic: dict) -> Layout:
    """The layout of a cell's answers: the state's size is the
    configuration's, or the traffic's where the configuration leaves it
    open (the scaling family's sweep)."""
    n = cfg.get("state_dim") or traffic.get("state_dim")
    if not n:
        raise ValueError("neither the configuration nor the traffic gives state_dim")
    return Layout(cfg["N"], int(n), cfg["n_drives"], cfg["chain"])


def pins(cfg: dict, lay: Layout):
    """Pinned columns and their values: x_0, u_0 and u_{N−1}."""
    idx = list(range(lay.col("x", 0), lay.col("x", 0) + lay.n))
    x0 = np.eye(lay.n)[0] if cfg["x_init"] == "e0" else np.asarray(cfg["x_init"], dtype=np.float64)
    val = list(x0)
    u = lay.chain[0]
    for k in (0, lay.N - 1):
        idx += list(range(lay.col(u, k), lay.col(u, k) + lay.m))
        val += [0.0] * lay.m
    return np.asarray(idx), np.asarray(val)


def bounds(cfg: dict, lay: Layout):
    """Lower and upper bounds (D,), ±inf where a column has none."""
    lb = np.full(lay.D, -np.inf)
    ub = np.full(lay.D, np.inf)
    u = lay.chain[0]
    for k in range(1, lay.N - 1):
        lb[lay.cols(u, k)] = -cfg["u_bound"]
        ub[lay.cols(u, k)] = cfg["u_bound"]
    for k in range(lay.N):
        lb[lay.col("dt", k)] = cfg["dt"]["lb"]
        ub[lay.col("dt", k)] = cfg["dt"]["ub"]
    return lb, ub


def _phi(cfg: dict, M: torch.Tensor) -> torch.Tensor:
    """Φ(M) for a stack of square matrices."""
    integ = cfg["integrator"]
    if integ["dynamics"] == "exp":
        return torch.linalg.matrix_exp(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    P = eye.expand_as(M)
    for j in range(integ["taylor_order"], 0, -1):
        P = eye + M @ P / j
    return P


def _split(lay: Layout, Z: torch.Tensor):
    Zm = Z.reshape(Z.shape[0], lay.N, lay.d)
    x = Zm[..., : lay.n]
    chain = [Zm[..., lay.offsets[c]: lay.offsets[c] + lay.m] for c in lay.chain]
    return x, chain, Zm[..., lay.offsets["dt"]]


def step_matrix(Gd, Gv, u, dt):
    """A_k = Δt_k G(u_k): (B, K, n, n) for Gd (B, n, n), Gv (B, m, n, n)."""
    G = Gd[:, None] + torch.einsum("bkm,bmij->bkij", u, Gv)
    return dt[..., None, None] * G


def residuals(cfg: dict, lay: Layout, Z, Gd, Gv) -> torch.Tensor:
    """Equality residuals (B, n_eq): the dynamics of every window, then each
    link of the chain."""
    x, chain, dt = _split(lay, Z)
    A = step_matrix(Gd, Gv, chain[0][:, :-1], dt[:, :-1])
    dyn = x[:, 1:] - (_phi(cfg, A) @ x[:, :-1, :, None])[..., 0]
    parts = [dyn.reshape(Z.shape[0], -1)]
    for a, b in zip(chain[:-1], chain[1:]):
        parts.append((a[:, 1:] - a[:, :-1] - dt[:, :-1, None] * b[:, :-1]).reshape(Z.shape[0], -1))
    return torch.cat(parts, dim=1)


def objective(cfg: dict, lay: Layout, Z) -> torch.Tensor:
    _, chain, dt = _split(lay, Z)
    f = torch.zeros(Z.shape[0], dtype=Z.dtype, device=Z.device)
    for name, c in zip(lay.chain, chain):
        w = cfg["regularize"].get(name)
        if w is not None:
            f = f + 0.5 * w * (dt ** 2 * (c * c).sum(-1)).sum(-1)
    return f


def optimum(cfg: dict) -> float:
    """The problem's optimal objective, the same for every lane: 0. The
    objective is a sum of squares of the chain, every member of which may be
    0 within its bounds (the pins hold u at 0, and nothing constrains the
    final state), and x then follows the drift from x_init: a feasible point
    at which the objective is 0."""
    if set(cfg["regularize"]) - set(cfg["chain"]):
        raise ValueError("the optimum is known only where the objective regularizes the chain")
    return 0.0


def gradient(cfg: dict, lay: Layout, Z) -> torch.Tensor:
    _, chain, dt = _split(lay, Z)
    g = torch.zeros_like(Z).reshape(Z.shape[0], lay.N, lay.d)
    for name, c in zip(lay.chain, chain):
        w = cfg["regularize"].get(name)
        if w is not None:
            o = lay.offsets[name]
            g[..., o: o + lay.m] += w * dt[..., None] ** 2 * c
            g[..., lay.offsets["dt"]] += w * dt * (c * c).sum(-1)
    return g.reshape(Z.shape)


def _frechet(cfg: dict, A, E):
    """Directional derivative of Φ at A along E (… , n, n), from Φ of the
    block matrix [[A, E], [0, A]], whose upper right block it is: exact for
    the exponential and for a polynomial alike."""
    n = A.shape[-1]
    blk = torch.zeros(A.shape[:-2] + (2 * n, 2 * n), dtype=A.dtype, device=A.device)
    blk[..., :n, :n] = A
    blk[..., n:, n:] = A
    blk[..., :n, n:] = E
    return _phi(cfg, blk)[..., :n, n:]


def jacobian(cfg: dict, lay: Layout, Z, Gd, Gv) -> torch.Tensor:
    """Dense Jacobian of :func:`residuals` (B, n_eq, D)."""
    B, N, n, m = Z.shape[0], lay.N, lay.n, lay.m
    x, chain, dt = _split(lay, Z)
    u = chain[0]
    A = step_matrix(Gd, Gv, u[:, :-1], dt[:, :-1])  # (B, K, n, n)
    G = Gd[:, None] + torch.einsum("bkm,bmij->bkij", u[:, :-1], Gv)
    dirs = torch.cat([dt[:, :-1, None, None, None] * Gv[:, None], G[:, :, None]], dim=2)
    dphi = _frechet(cfg, A[:, :, None].expand_as(dirs), dirs)  # (B, K, m+1, n, n)
    dx = (dphi @ x[:, :-1, None, :, None])[..., 0]  # (B, K, m+1, n)
    Phi = _phi(cfg, A)
    J = torch.zeros((B, lay.n_eq, lay.D), dtype=Z.dtype, device=Z.device)
    eye_n = torch.eye(n, dtype=Z.dtype, device=Z.device)
    eye_m = torch.eye(m, dtype=Z.dtype, device=Z.device)
    for k in range(N - 1):
        r = slice(k * n, (k + 1) * n)
        J[:, r, lay.cols("x", k + 1)] = eye_n
        J[:, r, lay.cols("x", k)] = -Phi[:, k]
        J[:, r, lay.cols(lay.chain[0], k)] = -dx[:, k, :m].transpose(-1, -2)
        J[:, r, lay.col("dt", k)] = -dx[:, k, m]
    r0 = (N - 1) * n
    for a, b in zip(lay.chain[:-1], lay.chain[1:]):
        for k in range(N - 1):
            r = slice(r0 + k * m, r0 + (k + 1) * m)
            J[:, r, lay.cols(a, k + 1)] = eye_m
            J[:, r, lay.cols(a, k)] = -eye_m
            J[:, r, lay.cols(b, k)] = -dt[:, k, None, None] * eye_m
            J[:, r, lay.col("dt", k)] = -Z.reshape(B, N, lay.d)[:, k, lay.cols(b, 0)]
        r0 += (N - 1) * m
    return J


def feasible(cfg: dict, lay: Layout, Z, problem: dict) -> torch.Tensor:
    """The point of the problem nearest Z's controls that meets every
    constraint (float64): Δt clipped to its bounds, u pinned and clipped,
    each lower member of the chain its upper member's difference quotient
    (the last knot's kept) and x rolled out from x_init by Φ."""
    Gd, Gv = problem["Gd"], problem["Gv"]
    Z = Z.to(F64).clone()
    B, N = Z.shape[0], lay.N
    Zm = Z.view(B, N, lay.d)
    o = lay.offsets
    Zm[..., o["dt"]].clamp_(cfg["dt"]["lb"], cfg["dt"]["ub"])
    dt = Zm[..., o["dt"]]
    u = lay.chain[0]
    Zm[:, 1:-1, o[u]: o[u] + lay.m].clamp_(-cfg["u_bound"], cfg["u_bound"])
    Zm[:, [0, -1], o[u]: o[u] + lay.m] = 0.0
    for a, b in zip(lay.chain[:-1], lay.chain[1:]):
        ca = Zm[..., o[a]: o[a] + lay.m]
        Zm[:, :-1, o[b]: o[b] + lay.m] = (ca[:, 1:] - ca[:, :-1]) / dt[:, :-1, None]
    pin_idx, pin_val = pins(cfg, lay)
    Z[:, pin_idx[: lay.n]] = torch.as_tensor(pin_val[: lay.n], dtype=F64, device=Z.device)
    A = step_matrix(Gd.to(F64), Gv.to(F64), Zm[:, :-1, o[u]: o[u] + lay.m], dt[:, :-1])
    Phi = _phi(cfg, A)
    for k in range(N - 1):
        Zm[:, k + 1, : lay.n] = (Phi[:, k] @ Zm[:, k, : lay.n, None])[..., 0]
    return Z


def controls(cfg: dict, lay: Layout):
    """The columns of Z that hold every knot's u, knot by knot, and their
    bound."""
    u = lay.chain[0]
    cols = [lay.col(u, k, i) for k in range(lay.N) for i in range(lay.m)]
    return np.array(cols), cfg["u_bound"]


def certificate(cfg: dict, lay: Layout, answer: dict, problem: dict) -> dict:
    """The five numbers of every lane (float64, (B,) each) for an answer
    ``Z`` (B, D) with bound multipliers ``zL``, ``zU`` (B, D) and reported
    ``objective`` (B,), on generators ``Gd`` (B, n, n) and ``Gv`` (B, m, n,
    n)."""
    Gd, Gv = problem["Gd"], problem["Gv"]
    dev = Gd.device
    Z, zL, zU, obj = (answer[k].to(device=dev, dtype=F64)
                      for k in ("Z", "zL", "zU", "objective"))
    Gd, Gv = Gd.to(F64), Gv.to(F64)
    pin_idx, pin_val = pins(cfg, lay)
    lb_np, ub_np = bounds(cfg, lay)
    lb, ub = (torch.as_tensor(b, device=dev) for b in (lb_np, ub_np))
    free = np.ones(lay.D, dtype=bool)
    free[pin_idx] = False
    free_t = torch.as_tensor(np.nonzero(free)[0], device=dev)
    has_l, has_u = torch.isfinite(lb), torch.isfinite(ub)

    c = residuals(cfg, lay, Z, Gd, Gv)
    pin_err = (Z[:, pin_idx] - torch.as_tensor(pin_val, device=dev)).abs()
    viol = torch.clamp(torch.maximum(lb - Z, Z - ub), min=0.0)
    feas = torch.maximum(c.abs().amax(1), torch.maximum(pin_err.amax(1), viol.amax(1)))

    g = gradient(cfg, lay, Z) - torch.where(has_l, zL, 0.0) + torch.where(has_u, zU, 0.0)
    J = jacobian(cfg, lay, Z, Gd, Gv)[:, :, free_t]
    J = J / J.norm(dim=2, keepdim=True).clamp_min(1e-300)  # rows to unit length
    gF = g[:, free_t]
    M = J @ J.transpose(1, 2)
    Lc, info = torch.linalg.cholesky_ex(M)
    lam = torch.cholesky_solve(-(J @ gF[..., None]), Lc)
    r = gF + (J.transpose(1, 2) @ lam)[..., 0]
    lam = lam + torch.cholesky_solve(-(J @ r[..., None]), Lc)  # one refinement
    r = gF + (J.transpose(1, 2) @ lam)[..., 0]
    stat = torch.where(info == 0, r.abs().amax(1), math.inf)

    zl_f, zu_f = zL[:, free_t], zU[:, free_t]
    dl = torch.where(has_l, Z - lb, 0.0)[:, free_t]
    du = torch.where(has_u, ub - Z, 0.0)[:, free_t]
    comp = torch.maximum((dl * zl_f).abs(), (du * zu_f).abs()).amax(1)
    neg = torch.clamp(torch.maximum(-zl_f, -zu_f), min=0.0).amax(1)
    comp = torch.maximum(comp, neg)

    f = objective(cfg, lay, Z)
    obj_gap = (obj - f).abs()
    opt_gap = f - optimum(cfg)
    out = dict(feas=feas, stat=stat, comp=comp, obj_gap=obj_gap, opt_gap=opt_gap)
    bad = ~torch.isfinite(Z).all(1)
    return {k: torch.where(bad | ~torch.isfinite(v), math.inf, v).cpu() for k, v in out.items()}
