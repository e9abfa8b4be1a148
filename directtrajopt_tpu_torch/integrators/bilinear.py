"""Bilinear integrator: ``x_{k+1} − exp(Δt_k·G(u_k))·x_k = 0``.

Counterpart of ``directtrajopt_tpu/integrators/bilinear.py``. The system
matrix is ``G(u) = G_drift + Σᵢ uᵢ·G_drives[i]`` with per-lane generators
``G_drift`` (B, x_dim, x_dim) and ``G_drives`` (B, u_dim, x_dim, x_dim), or
a callable ``G_fn(u)``: a torch function of one knot's u (no lane axis)
returning (x_dim, x_dim) in u's dtype, mapped over every window of every
lane with ``torch.func.vmap``. The exponential is Padé-13 with
``squarings`` scaling steps (``method="pade"``, the default, as in the JAX
package) or the Taylor action (``method="taylor"``).

Residuals and window Jacobians of the Taylor method with array generators
route through ``ops/expv_kernel.py``. The dtype gate is the JAX package's:
float32 residuals take the residual kernel, float64 residuals the generic
differentiable chain; the window Jacobian takes the closed-form recurrences
at both. Both kernels read the knot matrix in place
(:meth:`BilinearIntegrator._trial_views`), and the window-Jacobian kernel
writes the residual's Jacobian straight into the knot's width. The Padé
method and callable generators take the generic path (the closed forms
return None), as in the JAX package.
"""

from __future__ import annotations

import functools

from typing import Callable

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from ..module import module
from ..ops import expv_kernel
from ..ops.expm import expm_pade, expv_taylor
from ..precision import check_device
from ..trajectory import Layout
from .base import _embedding

__all__ = ["BilinearIntegrator"]


@module
class BilinearIntegrator:
    """``x_{k+1} = exp(Δt G(u_k)) x_k``; explicit (residual ``x_{k+1} − F(z_k)``)."""

    explicit = True

    G_drift: torch.Tensor | None
    G_drives: torch.Tensor | None
    x_name: str
    u_name: str
    method: str = "pade"
    taylor_order: int = 12
    G_fn: Callable | None = None
    squarings: int = 4

    @staticmethod
    def create(G, x_name: str, u_name: str, *, batch: int | None = None, device=None,
               dtype=torch.float64, method: str = "pade", taylor_order: int = 12,
               squarings: int = 4) -> "BilinearIntegrator":
        """From a callable ``G(u)`` or a ``(G_drift, G_drives)`` pair of host
        arrays, per problem ((x, x) and (u, x, x)) or per lane (with a
        leading batch axis of length ``batch``). ``device`` None means the
        card."""
        if method not in ("taylor", "pade"):
            raise ValueError(f"unknown method {method!r}")
        if callable(G):
            return BilinearIntegrator(G_drift=None, G_drives=None, x_name=x_name,
                                      u_name=u_name, method=method, taylor_order=taylor_order,
                                      G_fn=G, squarings=squarings)
        if batch is None:
            raise ValueError("array generators need the batch size")
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
            squarings=squarings,
        )

    def residual_dim(self, layout: Layout) -> int:
        return layout.dim_of(self.x_name)

    def read_cols(self, layout: Layout) -> list:
        """z_k columns the residual reads (x, u and a free Δt)."""
        cs_x, cs_u = layout.comp_slice(self.x_name), layout.comp_slice(self.u_name)
        cols = list(range(cs_x.start, cs_x.stop)) + list(range(cs_u.start, cs_u.stop))
        if layout.has_free_time:
            cols.append(layout.offsets[layout.timestep])
        return cols

    @property
    def _closed_form(self) -> bool:
        """Whether the kernels' closed forms apply: Taylor, array generators."""
        return self.G_fn is None and self.method == "taylor"

    def _gens(self, extra: int):
        """Generators viewed to broadcast over ``extra`` axes after the batch."""
        Gd, Gv = self.G_drift, self.G_drives
        one = (1,) * extra
        return (Gd.reshape(Gd.shape[:1] + one + Gd.shape[1:]),
                Gv.reshape(Gv.shape[:1] + one + Gv.shape[1:]))

    def system_matrix(self, u: torch.Tensor) -> torch.Tensor:
        """``G(u)`` (B, ..., x, x) for controls u (B, ..., u_dim)."""
        if self.G_fn is not None:
            out = vmap(self.G_fn)(u.reshape(-1, u.shape[-1]))
            return out.reshape(u.shape[:-1] + out.shape[-2:])
        Gd, Gv = self._gens(u.ndim - 2)
        return Gd + torch.einsum("...m,...mij->...ij", u, Gv)

    def _apply(self, u, dt, v, transpose: bool = False):
        """``exp(Δt·G(u)) v`` (or the adjoint action with ``transpose``)."""
        A = dt[..., None, None] * self.system_matrix(u)
        if transpose:
            A = A.transpose(-1, -2)
        if self.method == "taylor":
            return expv_taylor(A, v, order=self.taylor_order)
        return (expm_pade(A, squarings=self.squarings) @ v.unsqueeze(-1)).squeeze(-1)

    def residual(self, layout: Layout, zk: torch.Tensor, zk1: torch.Tensor) -> torch.Tensor:
        """Generic differentiable residual on windows ``zk``, ``zk1`` (B, ..., K, d)."""
        x = layout.knot_extract(zk, self.x_name)
        x_next = layout.knot_extract(zk1, self.x_name)
        u = layout.knot_extract(zk, self.u_name)
        return x_next - self._apply(u, layout.knot_timestep(zk), x)

    def hessian_zk(self, layout: Layout, zk: torch.Tensor, zk1: torch.Tensor,
                   mu: torch.Tensor) -> torch.Tensor:
        """Closed-form Hessian of ``μᵀ residual`` w.r.t. ``z_k`` per window,
        (B, K, d, d). The residual ``x_{k+1} − E(u,Δt)·x`` is linear in x, so
        with θ = (u, Δt): H_xx = 0, H_xθ = −∂_θ(E(θ)ᵀμ) (forward mode, one
        tangent per θ coordinate, on the adjoint action) and
        H_θθ = −∂²_θ(μᵀE(θ)x) (forward over reverse)."""
        d = layout.dim
        cs_x = layout.comp_slice(self.x_name)
        cs_u = layout.comp_slice(self.u_name)
        x = zk[..., cs_x]
        free_t = layout.has_free_time
        th_cols = list(range(cs_u.start, cs_u.stop))
        if free_t:
            th_cols.append(layout.offsets[layout.timestep])
        th0 = zk[..., th_cols]
        dt_fixed = None if free_t else layout.knot_timestep(zk)

        def split(th):
            if free_t:
                return th[..., :-1], th[..., -1]
            return th, dt_fixed

        def ETm(th):
            u_, dt_ = split(th)
            return self._apply(u_, dt_, mu, transpose=True)

        def mEx(th):
            u_, dt_ = split(th)
            return (mu * self._apply(u_, dt_, x)).sum()

        n_th = len(th_cols)
        eye = torch.eye(n_th, dtype=zk.dtype, device=zk.device)
        g = grad(mEx)
        Hxt = -vmap(lambda e: jvp(ETm, (th0,), (e.expand_as(th0),))[1])(eye).movedim(0, -1)
        Htt = -vmap(lambda e: jvp(g, (th0,), (e.expand_as(th0),))[1])(eye).movedim(0, -1)
        Ex = _embedding(np.arange(cs_x.start, cs_x.stop), d, zk.dtype, zk.device)
        Et = _embedding(np.asarray(th_cols), d, zk.dtype, zk.device)
        Hxt_full = Ex.T @ Hxt @ Et
        return Hxt_full + Hxt_full.transpose(-1, -2) + Et.T @ Htt @ Et

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
        (Taylor with array generators, float32 only; None sends the rest to
        the generic path)."""
        if not self._closed_form or zmat.dtype != torch.float32:
            return None
        out = expv_kernel.residual_action(self.taylor_order, *self._trial_views(layout, zmat))
        return out.reshape(zmat.shape[:-2] + out.shape[2:])

    def residuals_l1_stacked(self, layout: Layout, zmat: torch.Tensor):
        """``Σ|residual|`` per lane through the L1 form of the residual kernel
        (float32 only)."""
        if not self._closed_form or zmat.dtype != torch.float32:
            return None
        out = expv_kernel.residual_l1(self.taylor_order, *self._trial_views(layout, zmat))
        return out.reshape(zmat.shape[:-2])

    def jacobians_zk_stacked(self, layout: Layout, zmat: torch.Tensor) -> torch.Tensor:
        """Closed-form ``∂residual/∂z_k`` (B, *trial, N−1, x_dim, d) through
        the window-Jacobian kernel, which writes −J's columns (x, u, Δt) into
        z_k width: one allocation and one launch on the card. None for the
        Padé method or a callable generator (generic AD then)."""
        if not self._closed_form:
            return None
        out = expv_kernel.window_jac_zk(self.taylor_order, *self._window_jac_args(layout, zmat))
        return out.reshape(zmat.shape[:-2] + out.shape[2:])

    def __repr__(self) -> str:
        return f"BilinearIntegrator: {self.x_name} = exp(Δt G({self.u_name})) {self.x_name}"


@functools.lru_cache(maxsize=16)
def _scalar(value: float, dtype, device) -> torch.Tensor:
    """A 0-d tensor holding a fixed Δt, made once per (value, dtype, device)
    rather than filled on the device at every residual call."""
    return torch.full((), value, dtype=dtype, device=device)
