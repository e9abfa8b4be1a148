"""Trajectory data model: named per-knot components with a batch axis.

Counterpart of ``directtrajopt_tpu/trajectory.py``. Each named component is
a ``(B, N, dim)`` tensor (one lane per scenario, knot axis next), and the
per-problem metadata (initial / final / goal values, bounds) are ``(B, dim)``
tensors. The static index map of one knot vector is the :class:`Layout`.

Flat-vector interop uses the same layout as the JAX package:
``Z = [z_1; …; z_N; g]`` with each knot stacking its components in
declaration order, so ``to_zvec`` gives ``(B, N·dim)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Mapping, Sequence

import numpy as np
import torch

from .module import module
from .precision import check_device

__all__ = ["Layout", "Trajectory", "normalize_bound"]


@dataclass(frozen=True)
class Layout:
    """Static index map for a trajectory's knot vector."""

    names: tuple[str, ...]
    dims: tuple[int, ...]
    N: int
    timestep: str | float
    controls: tuple[str, ...] = ()
    global_names: tuple[str, ...] = ()
    global_dims: tuple[int, ...] = ()

    @cached_property
    def dim(self) -> int:
        return sum(self.dims)

    @cached_property
    def global_dim(self) -> int:
        return sum(self.global_dims)

    @cached_property
    def z_dim(self) -> int:
        return self.N * self.dim + self.global_dim

    @cached_property
    def offsets(self) -> dict[str, int]:
        out, o = {}, 0
        for name, d in zip(self.names, self.dims):
            out[name] = o
            o += d
        return out

    def dim_of(self, name: str) -> int:
        return self.dims[self.names.index(name)]

    def comp_slice(self, name: str) -> slice:
        """Index range of component ``name`` within one knot vector."""
        o = self.offsets[name]
        return slice(o, o + self.dim_of(name))

    @property
    def has_free_time(self) -> bool:
        return isinstance(self.timestep, str)

    def knot_extract(self, z: torch.Tensor, name: str) -> torch.Tensor:
        return z[..., self.comp_slice(name)]

    def knot_timestep(self, z: torch.Tensor) -> torch.Tensor:
        """Δt at each knot of ``z`` (..., dim): the component if free time,
        the constant otherwise."""
        if self.has_free_time:
            return z[..., self.offsets[self.timestep]]
        return torch.full(z.shape[:-1], float(self.timestep), dtype=z.dtype,
                          device=z.device)


def normalize_bound(bound, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """(lb, ub) vectors of shape (dim,) from a scalar (±|s|), a (lb, ub)
    pair, a (dim,) vector (±|v|) or a (dim, 2) array — the JAX package's
    bound forms."""
    if isinstance(bound, tuple) and len(bound) == 2:
        lb = np.broadcast_to(np.asarray(bound[0], dtype=float), (dim,))
        ub = np.broadcast_to(np.asarray(bound[1], dtype=float), (dim,))
        return lb, ub
    arr = np.asarray(bound, dtype=float)
    if arr.ndim == 0:
        s = abs(float(arr))
        return np.full((dim,), -s), np.full((dim,), s)
    if arr.ndim == 1:
        v = np.abs(arr)
        return -v, v
    if arr.ndim == 2 and arr.shape == (dim, 2):
        return arr[:, 0], arr[:, 1]
    raise ValueError(f"cannot interpret bound spec with shape {arr.shape} for dim {dim}")


def _lanes(value, B: int, shape_tail: tuple, device, dtype) -> torch.Tensor:
    """Broadcast host data (scalar, per-problem or per-lane) to a
    ``(B, *shape_tail)`` tensor on ``device``."""
    arr = np.broadcast_to(np.asarray(value, dtype=np.float64), (B,) + shape_tail)
    return torch.as_tensor(np.array(arr), dtype=dtype, device=device)


@module
class Trajectory:
    """Named per-knot variables with problem metadata, one lane per scenario.

    ``data[name] → (B, N, dim)``; ``initial/final/goal[name] → (B, dim)``;
    ``bounds[name] → (lb, ub)`` each ``(B, dim)``. Static: names order,
    timestep spec, controls.
    """

    data: dict
    initial: dict
    final: dict
    goal: dict
    bounds: dict
    names: tuple = ()
    timestep: str | float = 1.0
    controls: tuple = ()

    @staticmethod
    def create(
        data: Mapping[str, np.ndarray],
        *,
        timestep: str | float,
        device,
        dtype=torch.float64,
        controls: str | Sequence[str] = (),
        initial: Mapping | None = None,
        final: Mapping | None = None,
        goal: Mapping | None = None,
        bounds: Mapping | None = None,
    ) -> "Trajectory":
        """Build from host arrays. Components are ``(B, N, dim)`` (or
        ``(N, dim)`` / ``(N,)`` for one lane); metadata broadcast over lanes."""
        device = check_device(device)
        names = tuple(data.keys())
        arrs = {}
        for name in names:
            a = np.asarray(data[name], dtype=np.float64)
            if a.ndim == 1:
                a = a[:, None]
            if a.ndim == 2:
                a = a[None]
            arrs[name] = a
        B, N = arrs[names[0]].shape[:2]
        for name, a in arrs.items():
            if a.shape[:2] != (B, N):
                raise ValueError(f"component {name!r} has shape {a.shape}, expected ({B}, {N}, ·)")
        if isinstance(timestep, str) and timestep not in names:
            raise ValueError(f"timestep component {timestep!r} not in data")
        if isinstance(controls, str):
            controls = (controls,)
        dims = {n: a.shape[-1] for n, a in arrs.items()}

        def meta(m):
            out = {}
            for k, v in (m or {}).items():
                if k not in names:
                    raise ValueError(f"metadata references unknown component {k!r}")
                out[k] = _lanes(v, B, (dims[k],), device, dtype)
            return out

        bnds = {}
        for k, v in (bounds or {}).items():
            if k not in names:
                raise NotImplementedError(
                    f"bounds on {k!r}: global variables are not ported yet (ROADMAP Queue 1 item 9)"
                )
            lb, ub = normalize_bound(v, dims[k])
            bnds[k] = (_lanes(lb, B, (dims[k],), device, dtype),
                       _lanes(ub, B, (dims[k],), device, dtype))
        return Trajectory(
            data={n: torch.as_tensor(a, dtype=dtype, device=device) for n, a in arrs.items()},
            initial=meta(initial),
            final=meta(final),
            goal=meta(goal),
            bounds=bnds,
            names=names,
            timestep=timestep,
            controls=tuple(controls),
        )

    @property
    def B(self) -> int:
        return self.data[self.names[0]].shape[0]

    @property
    def N(self) -> int:
        return self.data[self.names[0]].shape[-2]

    @property
    def dims(self) -> dict[str, int]:
        return {name: self.data[name].shape[-1] for name in self.names}

    @property
    def dim(self) -> int:
        return sum(self.dims.values())

    @property
    def layout(self) -> Layout:
        return Layout(
            names=self.names,
            dims=tuple(self.data[name].shape[-1] for name in self.names),
            N=self.N,
            timestep=self.timestep,
            controls=self.controls,
        )

    def knot_matrix(self) -> torch.Tensor:
        """All components stacked per knot: ``(B, N, dim)``."""
        return torch.cat([self.data[name] for name in self.names], dim=-1)

    def to_zvec(self) -> torch.Tensor:
        """Flat decision vectors ``(B, N·dim)``."""
        zm = self.knot_matrix()
        return zm.reshape(zm.shape[0], -1)

    def from_zvec(self, z: torch.Tensor) -> "Trajectory":
        """A trajectory with its data taken from flat decision vectors."""
        layout = self.layout
        zmat = z[..., : layout.N * layout.dim].reshape(*z.shape[:-1], layout.N, layout.dim)
        return self.replace(
            data={name: zmat[..., layout.comp_slice(name)] for name in self.names}
        )

    def timesteps(self) -> torch.Tensor:
        """Per-knot Δt values, ``(B, N)``."""
        return self.layout.knot_timestep(self.knot_matrix())
