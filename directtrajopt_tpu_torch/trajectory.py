"""Trajectory data model: named per-knot components with a batch axis.

Counterpart of ``directtrajopt_tpu/trajectory.py``. Each named component is
a ``(B, N, dim)`` tensor (one lane per scenario, knot axis next), and the
per-problem metadata (initial / final / goal values, bounds) are ``(B, dim)``
tensors. The static index map of one knot vector is the :class:`Layout`.

Global (time-invariant) components live beside the knot components:
``global_data[name] → (B, dim)``, with bounds of their own.

Flat-vector interop uses the same layout as the JAX package:
``Z = [z_1; …; z_N; g]`` with each knot stacking its components in
declaration order and the global block g after the last knot, so
``to_zvec`` gives ``(B, N·dim + global_dim)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Mapping, Sequence

import numpy as np
import torch

from .module import module
from .precision import check_device

__all__ = ["Layout", "Trajectory", "normalize_bound", "traj_slice", "traj_index"]


def traj_slice(k: int, dim: int, comps: slice | None = None) -> slice:
    """Flat-Z indices of knot ``k`` (0-based): ``slice(k·dim, (k+1)·dim)``,
    or its sub-slice ``comps`` within the knot."""
    base = k * dim
    if comps is None:
        return slice(base, base + dim)
    return slice(base + comps.start, base + comps.stop)


def traj_index(k: int, comp: int, dim: int) -> int:
    """Flat-Z index of coordinate ``comp`` of knot ``k`` (0-based)."""
    return k * dim + comp


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

    @cached_property
    def global_offsets(self) -> dict[str, int]:
        out, o = {}, 0
        for name, d in zip(self.global_names, self.global_dims):
            out[name] = o
            o += d
        return out

    def dim_of(self, name: str) -> int:
        if name in self.offsets:
            return self.dims[self.names.index(name)]
        return self.global_dims[self.global_names.index(name)]

    def comp_slice(self, name: str) -> slice:
        """Index range of component ``name`` within one knot vector."""
        o = self.offsets[name]
        return slice(o, o + self.dim_of(name))

    def global_slice(self, name: str) -> slice:
        """Index range of global component ``name`` within the global block."""
        o = self.global_offsets[name]
        return slice(o, o + self.dim_of(name))

    def global_z_slice(self, name: str) -> slice:
        """Index range of global ``name`` in flat Z (after all knots)."""
        gs = self.global_slice(name)
        base = self.N * self.dim
        return slice(base + gs.start, base + gs.stop)

    def global_extract(self, g: torch.Tensor, names) -> torch.Tensor:
        """The named global components of global blocks ``g`` (..., global_dim),
        concatenated in the given order."""
        return torch.cat([g[..., self.global_slice(n)] for n in names], dim=-1)

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
    """Named per-knot variables and a global block, with problem metadata,
    one lane per scenario.

    ``data[name] → (B, N, dim)``; ``global_data[name] → (B, dim)``;
    ``initial/final/goal[name] → (B, dim)``; ``bounds[name] → (lb, ub)``
    each ``(B, dim)``, for knot and global components alike. Static: names
    order, global names order, timestep spec, controls.
    """

    data: dict
    initial: dict
    final: dict
    goal: dict
    bounds: dict
    global_data: dict = field(default_factory=dict)
    names: tuple = ()
    global_names: tuple = ()
    timestep: str | float = 1.0
    controls: tuple = ()

    @staticmethod
    def create(
        data: Mapping[str, np.ndarray],
        *,
        timestep: str | float,
        device=None,
        dtype=torch.float64,
        controls: str | Sequence[str] = (),
        initial: Mapping | None = None,
        final: Mapping | None = None,
        goal: Mapping | None = None,
        bounds: Mapping | None = None,
        global_data: Mapping | None = None,
    ) -> "Trajectory":
        """Build from host arrays. Components are ``(B, N, dim)`` (or
        ``(N, dim)`` / ``(N,)`` for one lane); global components ``(B, dim)``
        or ``(dim,)``; metadata broadcast over lanes. ``device`` None means
        the card (``precision.check_device``)."""
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
        gdata = {}
        for k, v in (global_data or {}).items():
            if k in names:
                raise ValueError(f"global component {k!r} shares its name with a knot component")
            a = np.atleast_1d(np.asarray(v, dtype=np.float64))
            gdata[k] = _lanes(a, B, (a.shape[-1],), device, dtype)
            dims[k] = a.shape[-1]

        def meta(m):
            out = {}
            for k, v in (m or {}).items():
                if k not in names:
                    raise ValueError(f"metadata references unknown component {k!r}")
                out[k] = _lanes(v, B, (dims[k],), device, dtype)
            return out

        bnds = {}
        for k, v in (bounds or {}).items():
            if k not in dims:
                raise ValueError(f"bounds reference unknown component {k!r}")
            lb, ub = normalize_bound(v, dims[k])
            bnds[k] = (_lanes(lb, B, (dims[k],), device, dtype),
                       _lanes(ub, B, (dims[k],), device, dtype))
        return Trajectory(
            data={n: torch.as_tensor(a, dtype=dtype, device=device) for n, a in arrs.items()},
            initial=meta(initial),
            final=meta(final),
            goal=meta(goal),
            bounds=bnds,
            global_data=gdata,
            names=names,
            global_names=tuple(gdata.keys()),
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
        """Width of every component, knot and global."""
        d = {name: self.data[name].shape[-1] for name in self.names}
        d.update({name: self.global_data[name].shape[-1] for name in self.global_names})
        return d

    @property
    def dim(self) -> int:
        """Width of one knot vector."""
        return sum(self.data[name].shape[-1] for name in self.names)

    @property
    def global_dim(self) -> int:
        return sum(self.global_data[name].shape[-1] for name in self.global_names)

    @property
    def layout(self) -> Layout:
        return Layout(
            names=self.names,
            dims=tuple(self.data[name].shape[-1] for name in self.names),
            N=self.N,
            timestep=self.timestep,
            controls=self.controls,
            global_names=self.global_names,
            global_dims=tuple(self.global_data[name].shape[-1] for name in self.global_names),
        )

    def knot_matrix(self) -> torch.Tensor:
        """All knot components stacked per knot: ``(B, N, dim)``."""
        return torch.cat([self.data[name] for name in self.names], dim=-1)

    def global_vec(self) -> torch.Tensor:
        """The global block ``(B, global_dim)`` (width 0 without globals)."""
        if not self.global_names:
            ref = self.data[self.names[0]]
            return ref.new_zeros((ref.shape[0], 0))
        return torch.cat([self.global_data[name] for name in self.global_names], dim=-1)

    def to_zvec(self) -> torch.Tensor:
        """Flat decision vectors ``(B, N·dim + global_dim)``."""
        zm = self.knot_matrix()
        z = zm.reshape(zm.shape[0], -1)
        if self.global_names:
            z = torch.cat([z, self.global_vec()], dim=-1)
        return z

    def from_zvec(self, z: torch.Tensor) -> "Trajectory":
        """A trajectory with its data (and global block) taken from flat
        decision vectors."""
        layout = self.layout
        nd = layout.N * layout.dim
        zmat = z[..., :nd].reshape(*z.shape[:-1], layout.N, layout.dim)
        g = z[..., nd:]
        return self.replace(
            data={name: zmat[..., layout.comp_slice(name)] for name in self.names},
            global_data={name: g[..., layout.global_slice(name)] for name in self.global_names},
        )

    def timesteps(self) -> torch.Tensor:
        """Per-knot Δt values, ``(B, N)``."""
        return self.layout.knot_timestep(self.knot_matrix())

    def get_duration(self) -> torch.Tensor:
        """Σ_{k<N-1} Δt_k per lane, ``(B,)``."""
        return self.timesteps()[:, :-1].sum(-1)

    def remove_components(self, names: Sequence[str]) -> "Trajectory":
        """A trajectory without the named components and their metadata."""
        drop = set(names)
        if isinstance(self.timestep, str) and self.timestep in drop:
            raise ValueError("cannot remove the timestep component")

        def keep(m):
            return {k: v for k, v in m.items() if k not in drop}

        return self.replace(
            data=keep(self.data), names=tuple(n for n in self.names if n not in drop),
            global_data=keep(self.global_data),
            global_names=tuple(n for n in self.global_names if n not in drop),
            bounds=keep(self.bounds), initial=keep(self.initial), final=keep(self.final),
            goal=keep(self.goal), controls=tuple(c for c in self.controls if c not in drop),
        )
