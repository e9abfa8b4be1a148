"""Bilinear integrator: ``x_{k+1} − exp(Δt_k·G(u_k))·x_k = 0``.

Counterpart of ``directtrajopt_tpu/integrators/bilinear.py``, Taylor method
only: ``G(u) = G_drift + Σᵢ uᵢ·G_drives[i]`` with per-lane generators
``G_drift`` (B, x_dim, x_dim) and ``G_drives`` (B, u_dim, x_dim, x_dim). The
Padé method and callable generators are not ported yet (ROADMAP Queue 1
item 12).

Residuals and window Jacobians route through ``ops/expv_kernel.py``. The
dtype gate is the JAX package's: float32 residuals take the residual
kernel, float64 residuals the generic differentiable chain; the window
Jacobian takes the closed-form recurrences at both.
"""

from __future__ import annotations

import numpy as np
import torch

from ..module import module
from ..ops import expv_kernel
from ..ops.expm import expv_taylor
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
    def create(G, x_name: str, u_name: str, *, batch: int, device, dtype=torch.float64,
               method: str = "taylor", taylor_order: int = 12) -> "BilinearIntegrator":
        """From a ``(G_drift, G_drives)`` pair of host arrays, per problem
        ((x, x) and (u, x, x)) or per lane (with a leading batch axis)."""
        if callable(G):
            raise NotImplementedError("callable generators are not ported yet (ROADMAP Queue 1 item 12)")
        if method != "taylor":
            raise NotImplementedError(f"method={method!r}: only 'taylor' is ported (ROADMAP Queue 1 item 12)")
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

    def _lane_args(self, layout: Layout, zmat: torch.Tensor):
        """Flatten (B, *extra) into lanes for the kernels: returns
        (Gd, Gv, u, dt, x, xn) contiguous with a leading lane axis."""
        lead = zmat.shape[:-2]
        Lanes = int(np.prod(lead))
        N = zmat.shape[-2]
        Gd, Gv = self._gens(len(lead) - 1)
        Gd = Gd.expand(lead + Gd.shape[-2:]).reshape(Lanes, *Gd.shape[-2:]).contiguous()
        Gv = Gv.expand(lead + Gv.shape[-3:]).reshape(Lanes, *Gv.shape[-3:]).contiguous()
        zm = zmat.reshape(Lanes, N, zmat.shape[-1])
        cs_x = layout.comp_slice(self.x_name)
        cs_u = layout.comp_slice(self.u_name)
        x = zm[:, :-1, cs_x].contiguous()
        xn = zm[:, 1:, cs_x].contiguous()
        u = zm[:, :-1, cs_u].contiguous()
        dt = layout.knot_timestep(zm[:, :-1]).contiguous()
        return Gd, Gv, u, dt, x, xn

    def residuals_stacked(self, layout: Layout, zmat: torch.Tensor):
        """Closed-form stacked residuals through the residual kernel
        (float32 only; None sends float64 to the generic path)."""
        if zmat.dtype != torch.float32:
            return None
        Gd, Gv, u, dt, x, xn = self._lane_args(layout, zmat)
        out = expv_kernel.residual_action(self.taylor_order, Gd, Gv, u, dt, x, xn)
        return out.reshape(zmat.shape[:-2] + out.shape[1:])

    def residuals_l1_stacked(self, layout: Layout, zmat: torch.Tensor):
        """``Σ|residual|`` per lane through the L1 form of the residual kernel
        (float32 only)."""
        if zmat.dtype != torch.float32:
            return None
        Gd, Gv, u, dt, x, xn = self._lane_args(layout, zmat)
        out = expv_kernel.residual_l1(self.taylor_order, Gd, Gv, u, dt, x, xn)
        return out.reshape(zmat.shape[:-2])

    def jacobians_zk_stacked(self, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
        """Closed-form ``∂residual/∂z_k`` (B, N−1, x_dim, d) through the
        window-Jacobian kernel: columns (x, u, Δt) scattered into z_k width."""
        Gd, Gv, u, dt, x, _ = self._lane_args(layout, zmat)
        free_t = layout.has_free_time
        J = expv_kernel.window_jac(self.taylor_order, free_t, Gd, Gv, u, dt, x)
        cs_x = layout.comp_slice(self.x_name)
        cs_u = layout.comp_slice(self.u_name)
        cols = list(range(cs_x.start, cs_x.stop)) + list(range(cs_u.start, cs_u.stop))
        if free_t:
            cols.append(layout.offsets[layout.timestep])
        out = torch.zeros(J.shape[:-1] + (layout.dim,), dtype=J.dtype, device=J.device)
        out[..., cols] = -J
        return out.reshape(zmat.shape[:-2] + out.shape[1:])

    def __repr__(self) -> str:
        return f"BilinearIntegrator: {self.x_name} = exp(Δt G({self.u_name})) {self.x_name}"
