"""The one generator of the benchmark's problems.

A cell's problems come from three places: the configuration file (the
family's fixed data: N, the generators' kind, pins, bounds), the traffic
file (lanes a call, the state's size where the configuration leaves it
open, and how the initial guesses are drawn) and ``--seed`` with the call's
index. Every call draws its own problems on the device, in a few large
calls, from a ``torch.Generator`` seeded by (seed, call); the same seed
gives the same problems, and every seed the same sizes.

The draws follow the repository's seeded constructors
(``benchmarks.make_batched_bilinear_problems`` with ``_np_bilinear_rollout``,
``benchmarks.scaled_data``) in distribution: Pauli or standard-normal
generators, uniform or normal controls, a Taylor-16 rollout of the guessed
controls or a normal state guess, standard-normal chain guesses, Δt ≡ 0.1.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


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


def call_generator(seed: int, call: int, device) -> torch.Generator:
    """A generator on ``device`` for call ``call`` of a run with ``seed``
    (any whole number; two calls or two seeds never share a stream)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(call) % (1 << 64)])
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]) >> 1)
    return g


def _draw(spec, shape, g, device):
    """One block of draws: ``{"uniform": s}`` on [−s, s], ``{"normal": s}``
    s·N(0, 1), or a constant."""
    if isinstance(spec, (int, float)):
        return torch.full(shape, float(spec), dtype=F64, device=device)
    (kind, s), = spec.items()
    if kind == "uniform":
        return s * (2 * torch.rand(shape, generator=g, dtype=F64, device=device) - 1)
    if kind == "normal":
        return s * torch.randn(shape, generator=g, dtype=F64, device=device)
    raise ValueError(f"unknown draw {kind!r}")


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


def draw_call(cfg: dict, traffic: dict, seed: int, call: int, device) -> dict:
    """The problems of one call: ``data`` (x, the chain, Δt as (B, N, ·)
    float64 tensors, the initial guess) and the generators ``Gd`` (B, n, n)
    and ``Gv`` (B, m, n, n)."""
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
    return dict(data=data, Gd=Gd, Gv=Gv)
