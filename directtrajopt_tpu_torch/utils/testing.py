"""Finite-difference derivative validators.

Counterpart of ``directtrajopt_tpu/utils/testing.py`` (the reference's
``test_integrator``, ``test_objective`` and ``test_constraint``): every
component's AD derivatives are checked against central finite differences
on the flat decision vector. The port's trajectories hold B lanes; the
checks run on every lane, each with the other lanes held fixed.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd

from ..integrators.base import stack_hessians, stack_jacobians, stack_residuals
from ..trajectory import Trajectory

__all__ = [
    "finite_difference_jacobian",
    "finite_difference_hessian",
    "assemble_window_jacobian",
    "assemble_window_hessian",
    "check_integrator",
]


def finite_difference_jacobian(f: Callable, x: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Central-difference Jacobian of ``f: (n,) -> (m,)``."""
    x = np.asarray(x, dtype=np.float64)
    f0 = np.asarray(f(x))
    J = np.zeros((f0.shape[0], x.shape[0]))
    for i in range(x.shape[0]):
        dx = np.zeros_like(x)
        dx[i] = eps
        J[:, i] = (np.asarray(f(x + dx)) - np.asarray(f(x - dx))) / (2 * eps)
    return J


def finite_difference_hessian(f: Callable, x: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Central-difference Hessian of a scalar function."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    H = np.zeros((n, n))
    for i in range(n):
        for j in range(i, n):
            ei = np.zeros(n)
            ej = np.zeros(n)
            ei[i] = eps
            ej[j] = eps
            fpp = float(f(x + ei + ej))
            fpm = float(f(x + ei - ej))
            fmp = float(f(x - ei + ej))
            fmm = float(f(x - ei - ej))
            H[i, j] = H[j, i] = (fpp - fpm - fmp + fmm) / (4 * eps**2)
    return H


def assemble_window_jacobian(blocks, N: int, dim: int, z_dim: int) -> np.ndarray:
    """Scatter one lane's per-window Jacobian blocks ``(N-1, r, 2dim)`` into a
    dense ``(r*(N-1), z_dim)`` matrix (rows per step, cols spanning knots k,
    k+1)."""
    blocks = _host(blocks)
    r = blocks.shape[1]
    J = np.zeros((r * (N - 1), z_dim))
    for k in range(N - 1):
        J[k * r : (k + 1) * r, k * dim : (k + 2) * dim] = blocks[k]
    return J


def assemble_window_hessian(blocks, N: int, dim: int, z_dim: int) -> np.ndarray:
    """Accumulate one lane's per-window Hessian blocks ``(N-1, 2dim, 2dim)``
    into a dense ``(z_dim, z_dim)`` matrix."""
    blocks = _host(blocks)
    H = np.zeros((z_dim, z_dim))
    for k in range(N - 1):
        H[k * dim : (k + 2) * dim, k * dim : (k + 2) * dim] += blocks[k]
    return H


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _lane(fn, Z0: torch.Tensor, b: int):
    """``fn`` (B, z_dim) → (B, ...) as a function of lane ``b``'s flat
    vector alone (a tensor), the other lanes held at ``Z0``."""
    def f(z):
        return fn(torch.cat([Z0[:b], z[None], Z0[b + 1:]]))[b]
    return f


def _numpy_fn(f, dtype):
    """A tensor function as a numpy one (for the finite differences)."""
    def g(z):
        return _host(f(torch.as_tensor(np.asarray(z), dtype=dtype)))
    return g


def check_objective(obj, traj: Trajectory, atol: float = 1e-5) -> None:
    """Validate an objective's AD gradient and Hessian against finite
    differences on every lane (the reference's ``test_objective``)."""
    from ..objectives.base import objective_value

    Z0 = traj.to_zvec()

    def val(Z):
        return objective_value(obj, traj.from_zvec(Z))

    for b in range(Z0.shape[0]):
        f = _lane(val, Z0, b)
        g_ad = _host(grad(f)(Z0[b]))
        g_fd = finite_difference_jacobian(lambda z: _numpy_fn(f, Z0.dtype)(z)[None], _host(Z0[b]))[0]
        np.testing.assert_allclose(g_ad, g_fd, atol=atol, rtol=0)
        H_ad = _host(hessian(f)(Z0[b]))
        H_fd = finite_difference_hessian(_numpy_fn(f, Z0.dtype), _host(Z0[b]))
        np.testing.assert_allclose(H_ad, H_fd, atol=max(atol * 100, 1e-4), rtol=0)


def check_constraint(con, traj: Trajectory, atol: float = 1e-5) -> None:
    """Validate a nonlinear constraint's AD Jacobian and the Hessian of a
    random combination of its rows against finite differences on every
    lane (the reference's ``test_constraint``)."""
    layout = traj.layout
    Z0 = traj.to_zvec()

    def flat(Z):
        tr = traj.from_zvec(Z)
        return con.evaluate_flat(layout, tr.knot_matrix(), tr.global_vec())

    rng = np.random.default_rng(7)
    mu = None
    for b in range(Z0.shape[0]):
        f = _lane(flat, Z0, b)
        J_ad = _host(jacfwd(f)(Z0[b]))
        J_fd = finite_difference_jacobian(_numpy_fn(f, Z0.dtype), _host(Z0[b]))
        np.testing.assert_allclose(J_ad, J_fd, atol=atol, rtol=0)
        if mu is None:
            mu = torch.as_tensor(rng.normal(size=(J_ad.shape[0],)), dtype=Z0.dtype)

        def lagr(z, f=f):
            return (mu * f(z)).sum()

        H_ad = _host(hessian(lagr)(Z0[b]))
        H_fd = finite_difference_hessian(_numpy_fn(lagr, Z0.dtype), _host(Z0[b]))
        np.testing.assert_allclose(H_ad, H_fd, atol=max(atol * 100, 1e-4), rtol=0)


def check_integrator(integrator, traj: Trajectory, atol: float = 1e-5,
                     hessian_atol: float | None = None) -> None:
    """Validate an integrator's window Jacobians and Hessians (the ones the
    solver uses: ``stack_jacobians`` and ``stack_hessians``) against finite
    differences of its residuals on every lane."""
    layout = traj.layout
    N, dim, z_dim = layout.N, layout.dim, layout.z_dim
    r = integrator.residual_dim(layout)
    Z0 = traj.to_zvec()
    zmat = traj.knot_matrix()

    def flat_residual(Z):
        res = stack_residuals(integrator, layout, traj.from_zvec(Z).knot_matrix())
        return res.reshape(res.shape[0], -1)

    rng = np.random.default_rng(42)
    mu = rng.normal(size=(N - 1, r))
    mu_t = torch.as_tensor(mu, dtype=Z0.dtype, device=Z0.device).expand(Z0.shape[0], N - 1, r)
    blocks = stack_jacobians(integrator, layout, zmat)
    hblocks = stack_hessians(integrator, layout, zmat, mu_t)
    for b in range(Z0.shape[0]):
        res_b = _numpy_fn(_lane(flat_residual, Z0, b), Z0.dtype)
        z0 = _host(Z0[b])
        J_ad = assemble_window_jacobian(blocks[b], N, dim, z_dim)
        np.testing.assert_allclose(J_ad, finite_difference_jacobian(res_b, z0), atol=atol, rtol=0)
        H_ad = assemble_window_hessian(hblocks[b], N, dim, z_dim)
        H_fd = finite_difference_hessian(lambda z: float(mu.reshape(-1) @ res_b(z)), z0)
        np.testing.assert_allclose(
            H_ad, H_fd, atol=hessian_atol if hessian_atol is not None else 10 * atol, rtol=0)
