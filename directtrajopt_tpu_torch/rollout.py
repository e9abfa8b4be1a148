"""Forward dynamics rollouts.

Counterpart of ``directtrajopt_tpu/rollout.py``: simulate the discrete
dynamics forward under given controls — to build problems that are
feasible by construction (a rolled-out final state as the goal) and to
check the fidelity of a solution. A Python loop over knots replaces
``lax.scan``; every lane of a batch rolls out at once.
"""

from __future__ import annotations

import torch

from .ops.expm import expm_pade
from .trajectory import Trajectory

__all__ = ["rollout", "bilinear_rollout", "rollout_fidelity"]


def bilinear_rollout(integrator, x0: torch.Tensor, u: torch.Tensor, dts,
                     squarings: int = 4) -> torch.Tensor:
    """Roll out ``x_{k+1} = exp(Δt_k G(u_k)) x_k`` (Padé, as the JAX package).

    ``x0`` (B, x_dim), ``u`` (B, N, u_dim) (the last knot is unused), ``dts``
    a scalar or (B, N); the integrator's generators are per lane. Returns
    the states (B, N, x_dim)."""
    N = u.shape[1]
    dts = torch.as_tensor(dts, dtype=x0.dtype, device=x0.device).expand(u.shape[0], N)
    xs = [x0]
    for k in range(N - 1):
        G = integrator.G_drift + torch.einsum("bm,bmij->bij", u[:, k], integrator.G_drives)
        E = expm_pade(dts[:, k, None, None] * G, squarings=squarings)
        xs.append((E @ xs[-1].unsqueeze(-1)).squeeze(-1))
    return torch.stack(xs, dim=1)


def rollout(integrator, traj: Trajectory, x_name: str | None = None) -> torch.Tensor:
    """Roll out an explicit integrator along a trajectory's controls: the
    residual ``x_{k+1} − F(z_k)`` at a zero next knot gives ``−F(z_k)``.
    Returns (B, N, x_dim)."""
    layout = traj.layout
    zmat = traj.knot_matrix()
    cs = layout.comp_slice(x_name or integrator.x_name)
    x = zmat[:, 0, cs]
    xs = [x]
    for k in range(layout.N - 1):
        zk = zmat[:, k].clone()
        zk[:, cs] = x
        x = -integrator.residual(layout, zk[:, None], torch.zeros_like(zk)[:, None])[:, 0]
        xs.append(x)
    return torch.stack(xs, dim=1)


def rollout_fidelity(integrator, traj: Trajectory, goal: torch.Tensor,
                     x_name: str | None = None) -> torch.Tensor:
    """Normalized overlap |⟨goal, x_N⟩|² / (‖goal‖² ‖x_N‖²) of each lane's
    rolled-out final state, ``goal`` (B, x_dim); returns (B,)."""
    xN = rollout(integrator, traj, x_name)[:, -1]
    goal = goal.to(xN.dtype)
    num = (goal * xN).sum(-1).abs() ** 2
    den = torch.clamp((goal * goal).sum(-1) * (xN * xN).sum(-1), min=1e-30)
    return num / den
