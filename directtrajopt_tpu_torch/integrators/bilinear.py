"""Bilinear integrator: ``x_{k+1} − exp(Δt_k·G(u_k))·x_k = 0``.

Counterpart of ``directtrajopt_tpu/integrators/bilinear.py``, Taylor method
only: ``G(u) = G_drift + Σᵢ uᵢ·G_drives[i]`` with per-lane generators
``G_drift`` (B, x_dim, x_dim) and ``G_drives`` (B, u_dim, x_dim, x_dim). The
Padé method and callable generators are not ported yet (ROADMAP Queue 1
item 7).

Residuals and window Jacobians route through ``ops/expv_kernel.py``. The
dtype gate is the JAX package's: float32 residuals take the residual
kernel, float64 residuals the generic differentiable chain; the window
Jacobian takes the closed-form recurrences at both. Both kernels read the
knot matrix in place (:meth:`BilinearIntegrator._trial_views`), and the
window-Jacobian kernel writes the residual's Jacobian straight into the
knot's width.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..module import module
from ..ops import expv_kernel
from ..ops.expm import expv_taylor
from ..precision import check_device
from ..trajectory import Layout

__all__ = ["BilinearIntegrator"]


@module
class BilinearIntegrator:
    """``x_{k+1} = exp(Δt G(u_k)) x_k``; explicit (residual ``x_{k+1} − F(z_k)``)."""

    explicit = True

    G_drift: torch.Tensor
    G_drives: torch.Tensor
    x_name: str
    u_name: str
    method: str = "taylor"
    taylor_order: int = 12

    @staticmethod
    def create(G, x_name: str, u_name: str, *, batch: int, device=None, dtype=torch.float64,
               method: str = "taylor", taylor_order: int = 12) -> "BilinearIntegrator":
        """From a ``(G_drift, G_drives)`` pair of host arrays, per problem
        ((x, x) and (u, x, x)) or per lane (with a leading batch axis).
        ``device`` None means the card."""
        if callable(G):
            raise NotImplementedError("callable generators are not ported yet (ROADMAP Queue 1 item 7)")
        if method != "taylor":
            raise NotImplementedError(f"method={method!r}: only 'taylor' is ported (ROADMAP Queue 1 item 7)")
        device = check_device(device)
        G_drift, G_drives = G
        Gd = np.asarray(G_drift, dtype=np.float64)
        Gv = np.asarray(G_drives, dtype=np.float64)
        xd = Gd.shape[-1]
        nd = Gv.shape[-3]
        Gd = np.broadcast_to(Gd, (batch, xd, xd))
        Gv = np.broadcast_to(Gv, (batch, nd, xd, xd))
        kw = dict(dtype=dtype, device=device)
        return BilinearIntegrator(
            G_drift=torch.as_tensor(np.array(Gd), **kw),
            G_drives=torch.as_tensor(np.array(Gv), **kw),
            x_name=x_name, u_name=u_name, method=method, taylor_order=taylor_order,
        )

    def residual_dim(self, layout: Layout) -> int:
        return layout.dim_of(self.x_name)

    def _gens(self, extra: int):
        """Generators viewed to broadcast over ``extra`` axes after the batch."""
        Gd, Gv = self.G_drift, self.G_drives
        one = (1,) * extra
        return (Gd.reshape(Gd.shape[:1] + one + Gd.shape[1:]),
                Gv.reshape(Gv.shape[:1] + one + Gv.shape[1:]))

    def residual(self, layout: Layout, zk: torch.Tensor, zk1: torch.Tensor) -> torch.Tensor:
        """Generic differentiable residual on windows ``zk``, ``zk1`` (B, ..., K, d)."""
        x = layout.knot_extract(zk, self.x_name)
        x_next = layout.knot_extract(zk1, self.x_name)
        u = layout.knot_extract(zk, self.u_name)
        dt = layout.knot_timestep(zk)
        Gd, Gv = self._gens(zk.ndim - 2)
        G = Gd + torch.einsum("...m,...mij->...ij", u, Gv)
        return x_next - expv_taylor(dt[..., None, None] * G, x, order=self.taylor_order)

    def _trial_views(self, layout: Layout, zmat: torch.Tensor):
        """The residual kernel's arguments (the window-Jacobian kernel's
        without x_next), all views: the knot matrix
        (B, *trial, N, d) seen as (P=B, T, N, d), its trial axes flattened
        into T (T = 1 without them), and u, Δt, x, x_next as (P, T, N−1, ·)
        views of it (``as_strided`` on its strides, one knot further on for
        x_next); a fixed Δt is a scalar expanded with stride 0. The
        generators are the per-problem (B, ·) tensors as they lie, broadcast
        over T by the kernel."""
        N, d = zmat.shape[-2:]
        z = zmat.reshape(zmat.shape[0], -1, N, d)
        lead = z.shape[:2] + (N - 1,)
        st, base = z.stride(), z.storage_offset()
        o_x, o_u = layout.offsets[self.x_name], layout.offsets[self.u_name]
        xd, nd = self.G_drift.shape[-1], self.G_drives.shape[-3]
        x = z.as_strided(lead + (xd,), st, base + o_x)
        xn = z.as_strided(lead + (xd,), st, base + st[2] + o_x)
        u = z.as_strided(lead + (nd,), st, base + o_u)
        if layout.has_free_time:
            dt = z.as_strided(lead, st[:3], base + layout.offsets[layout.timestep])
        else:
            dt = _scalar(float(layout.timestep), z.dtype, z.device).expand(lead)
        return self.G_drift, self.G_drives, u, dt, x, xn

    def _window_jac_args(self, layout: Layout, zmat: torch.Tensor):
        """The window-Jacobian kernel's arguments after the Taylor order: the
        views of :meth:`_trial_views` without x_next, then where J's columns
        go in the knot, (o_x, o_u, o_Δt; None for a fixed Δt), and the
        knot's width."""
        o_t = layout.offsets[layout.timestep] if layout.has_free_time else None
        cols = (layout.offsets[self.x_name], layout.offsets[self.u_name], o_t)
        return self._trial_views(layout, zmat)[:5] + (cols, layout.dim)

    def residuals_stacked(self, layout: Layout, zmat: torch.Tensor):
        """Closed-form stacked residuals through the residual kernel
        (float32 only; None sends float64 to the generic path)."""
        if zmat.dtype != torch.float32:
            return None
        out = expv_kernel.residual_action(self.taylor_order, *self._trial_views(layout, zmat))
        return out.reshape(zmat.shape[:-2] + out.shape[2:])

    def residuals_l1_stacked(self, layout: Layout, zmat: torch.Tensor):
        """``Σ|residual|`` per lane through the L1 form of the residual kernel
        (float32 only)."""
        if zmat.dtype != torch.float32:
            return None
        out = expv_kernel.residual_l1(self.taylor_order, *self._trial_views(layout, zmat))
        return out.reshape(zmat.shape[:-2])

    def jacobians_zk_stacked(self, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
        """Closed-form ``∂residual/∂z_k`` (B, *trial, N−1, x_dim, d) through
        the window-Jacobian kernel, which writes −J's columns (x, u, Δt) into
        z_k width: one allocation and one launch on the card."""
        out = expv_kernel.window_jac_zk(self.taylor_order, *self._window_jac_args(layout, zmat))
        return out.reshape(zmat.shape[:-2] + out.shape[2:])

    def __repr__(self) -> str:
        return f"BilinearIntegrator: {self.x_name} = exp(Δt G({self.u_name})) {self.x_name}"


@functools.lru_cache(maxsize=16)
def _scalar(value: float, dtype, device) -> torch.Tensor:
    """A 0-d tensor holding a fixed Δt, made once per (value, dtype, device)
    rather than filled on the device at every residual call."""
    return torch.full((), value, dtype=dtype, device=device)
