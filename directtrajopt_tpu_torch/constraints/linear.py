"""The linear constraint zoo.

Counterpart of ``directtrajopt_tpu/constraints/linear.py``: pins, box bounds
and the affine-row constraints, each lowering to the canonical pins /
bounds / COO rows of :class:`~.base.LinearCanon`. All time indices are
0-based. Per-lane data (pin values, bounds, totals) are ``(B, ·)`` tensors;
row coefficients are shared by the lanes. The ``Global*`` constraints act
on the global block, whose columns follow the knots' in flat Z.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..module import module
from ..trajectory import Layout, normalize_bound
from .base import LinearCanon, LinearConstraintBase

__all__ = [
    "EqualityConstraint",
    "GlobalEqualityConstraint",
    "fix_trajectory_variable",
    "fix_global_variable",
    "BoundsConstraint",
    "GlobalBoundsConstraint",
    "AllEqualConstraint",
    "TimeStepsAllEqualConstraint",
    "TotalConstraint",
    "DurationConstraint",
    "SymmetryConstraint",
    "SymmetricControlConstraint",
    "TimeConsistencyConstraint",
    "L1SlackConstraint",
    "GlobalLinearConstraint",
]


def _z_indices(layout: Layout, name: str, times: Sequence[int], sub: slice | None = None):
    """Flat-Z indices of component ``name`` at the given knots (stacked)."""
    cs = layout.comp_slice(name)
    comp_idx = np.arange(cs.start, cs.stop)
    if sub is not None:
        comp_idx = comp_idx[sub]
    return np.concatenate([t * layout.dim + comp_idx for t in times]), len(comp_idx)


def _lane_values(values, traj, width: int | None = None) -> torch.Tensor:
    """Per-lane values ``(B, n)``: a tensor as it is (one row broadcast over
    the lanes), host data broadcast over ``traj``'s lanes on its device."""
    ref = traj.data[traj.names[0]]
    if isinstance(values, torch.Tensor):
        v = values.to(dtype=ref.dtype, device=ref.device)
        return v.reshape(1, -1).expand(traj.B, -1) if v.ndim < 2 else v.reshape(v.shape[0], -1)
    a = np.asarray(values, dtype=np.float64).reshape(-1)
    if width is not None:
        a = np.broadcast_to(a, (width,))
    return torch.as_tensor(np.broadcast_to(a, (traj.B, a.shape[0])).copy(), dtype=ref.dtype,
                           device=ref.device)


def _resolve_timestep_name(layout: Layout, name: str | None) -> str:
    if name is not None:
        return name
    if not layout.has_free_time:
        raise ValueError("trajectory has no free timestep variable")
    return layout.timestep


@module
class EqualityConstraint(LinearConstraintBase):
    """Pin a component to ``values`` (B, dim) or (B, T·dim) at the given knots."""

    values: torch.Tensor
    name: str
    times: tuple
    label: str = "equality constraint"

    @staticmethod
    def create(name, times, values: torch.Tensor, *, label=None):
        times = tuple(int(t) for t in np.atleast_1d(times))
        return EqualityConstraint(
            values=values, name=name, times=times,
            label=label or f"equality constraint on {name}",
        )

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        idx, d = _z_indices(layout, self.name, self.times)
        vals = self.values.reshape(self.values.shape[0], -1)
        if vals.shape[1] == 1 and d > 1:
            vals = vals.expand(-1, d)
        if vals.shape[1] == d:
            tiled = vals.repeat(1, len(self.times))
        elif vals.shape[1] == d * len(self.times):
            tiled = vals
        else:
            raise ValueError(f"values shape {tuple(self.values.shape)} does not fit ({len(self.times)}, {d})")
        canon.pin(idx, tiled)


@module
class GlobalEqualityConstraint(LinearConstraintBase):
    """Pin a global component to ``values`` (B, dim), or (B, 1) for all of it."""

    values: torch.Tensor
    name: str
    label: str = "global equality constraint"

    @staticmethod
    def create(name, values, *, traj, label=None):
        """``values``: a tensor (B, dim), or host data broadcast over
        ``traj``'s lanes."""
        return GlobalEqualityConstraint(
            values=_lane_values(values, traj), name=name,
            label=label or f"equality constraint on global {name}",
        )

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        gs = layout.global_z_slice(self.name)
        idx = np.arange(gs.start, gs.stop)
        canon.pin(idx, self.values.expand(self.values.shape[0], len(idx)))


def fix_trajectory_variable(traj, name: str, times, values):
    """Pin a trajectory variable at ``times`` and drop its bounds (which a
    pin makes moot); returns (trajectory, constraint). ``values`` as for
    :class:`EqualityConstraint`, or host data broadcast over the lanes."""
    new_bounds = {k: v for k, v in traj.bounds.items() if k != name}
    if not isinstance(values, torch.Tensor):
        values = _lane_values(values, traj)
    return traj.replace(bounds=new_bounds), EqualityConstraint.create(
        name, times, values, label=f"fixed variable {name}")


def fix_global_variable(traj, name: str, values):
    """Pin a global variable and drop its bounds; returns (trajectory,
    constraint)."""
    new_bounds = {k: v for k, v in traj.bounds.items() if k != name}
    return traj.replace(bounds=new_bounds), GlobalEqualityConstraint.create(
        name, values, traj=traj, label=f"fixed global variable {name}")


@module
class BoundsConstraint(LinearConstraintBase):
    """Box bounds ``lb ≤ v ≤ ub`` (each (B, n)) on a component over knots."""

    lb: torch.Tensor
    ub: torch.Tensor
    name: str
    times: tuple
    subcomponents: tuple | None = None
    label: str = "bounds constraint"

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        sub = slice(*self.subcomponents) if self.subcomponents else None
        idx, _ = _z_indices(layout, self.name, self.times, sub)
        T = len(self.times)
        canon.bound(idx, self.lb.repeat(1, T), self.ub.repeat(1, T))


@module
class GlobalBoundsConstraint(LinearConstraintBase):
    """Box bounds ``lb ≤ g ≤ ub`` (each (B, dim)) on a global component."""

    lb: torch.Tensor
    ub: torch.Tensor
    name: str
    label: str = "global bounds constraint"

    @staticmethod
    def create(name, bound, traj, *, label=None):
        """``bound`` in any of the forms of ``normalize_bound``."""
        lb, ub = normalize_bound(bound, traj.dims[name])
        return GlobalBoundsConstraint(lb=_lane_values(lb, traj), ub=_lane_values(ub, traj),
                                      name=name, label=label or f"bounds on global {name}")

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        gs = layout.global_z_slice(self.name)
        canon.bound(np.arange(gs.start, gs.stop), self.lb, self.ub)


@module
class AllEqualConstraint(LinearConstraintBase):
    """All knots of one component equal, as the chain rows
    ``v_{k+1} − v_k = 0`` (promotable into the Riccati core).
    ``name=None`` means the trajectory's timestep variable."""

    name: str | None = None
    component_index: int = 0
    label: str = "all equal constraint"

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        name = _resolve_timestep_name(layout, self.name)
        comp = layout.comp_slice(name).start + self.component_index
        N, dim = layout.N, layout.dim
        n_rows = N - 1
        rows = np.repeat(np.arange(n_rows), 2)
        cols = np.stack([(np.arange(N - 1) + 1) * dim + comp, np.arange(N - 1) * dim + comp],
                        axis=1).reshape(-1)
        vals = np.tile(np.asarray([1.0, -1.0]), n_rows)
        canon.add_eq_rows(rows, cols, vals, np.zeros(n_rows), n_rows)


def TimeStepsAllEqualConstraint(*, label="timesteps all equal constraint"):
    """All timesteps equal (fixed-Δt trajectories with a Δt variable)."""
    return AllEqualConstraint(name=None, component_index=0, label=label)


@module
class TotalConstraint(LinearConstraintBase):
    """``Σ_k v_k[comp] = value`` — one affine row; for the timestep variable
    only the first N−1 knots are summed. With ``lb=`` / ``ub=`` instead of a
    value, the total is held in a range by multi-knot inequality rows (border
    inequalities on the Riccati path). ``value`` (B, k) holds (v,), (ub,),
    (lb,) or (ub, lb) per the flags."""

    value: torch.Tensor
    name: str | None = None
    component_index: int = 0
    label: str = "total constraint"
    is_eq: bool = True
    has_lb: bool = False
    has_ub: bool = False

    @staticmethod
    def create(name, value=None, *, traj, lb=None, ub=None, component_index=0, label=None):
        """``traj`` gives the lane count, device and dtype of ``value``."""
        if (value is None) == (lb is None and ub is None):
            raise ValueError("pass either value= (equality) or lb=/ub= (range)")
        if value is not None:
            parts, is_eq, has_lb, has_ub = [float(value)], True, False, False
        else:
            parts = ([float(ub)] if ub is not None else []) + ([float(lb)] if lb is not None else [])
            is_eq, has_lb, has_ub = False, lb is not None, ub is not None
        ref = traj.data[traj.names[0]]
        vals = torch.tensor(parts, dtype=ref.dtype, device=ref.device).expand(traj.B, -1)
        return TotalConstraint(
            value=vals.contiguous(), name=name, component_index=component_index,
            label=label or f"total constraint on {name}", is_eq=is_eq, has_lb=has_lb,
            has_ub=has_ub,
        )

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        name = _resolve_timestep_name(layout, self.name)
        comp = layout.comp_slice(name).start + self.component_index
        n_t = layout.N - 1 if name == layout.timestep else layout.N
        cols = np.arange(n_t) * layout.dim + comp
        rows = np.zeros(n_t)
        ones = torch.ones(n_t, dtype=torch.float64)
        val = self.value
        if self.is_eq:
            canon.add_eq_rows(rows, cols, ones, val[:, :1], 1)
            return
        # Σv ≤ ub and −Σv ≤ −lb for the finite sides
        pos = 0
        if self.has_ub:
            canon.add_ineq_rows(rows, cols, ones, val[:, pos : pos + 1], 1)
            pos += 1
        if self.has_lb:
            canon.add_ineq_rows(rows, cols, -ones, -val[:, pos : pos + 1], 1)


def DurationConstraint(value=None, *, traj, lb=None, ub=None, label=None):
    """Total duration Σ_{k<N-1} Δt_k = value, or lb ≤ Σ Δt ≤ ub."""
    return TotalConstraint.create(
        None, value, traj=traj, lb=lb, ub=ub, component_index=0,
        label=label or (f"duration constraint of {value}" if value is not None
                        else f"duration range [{lb}, {ub}]"),
    )


@module
class SymmetryConstraint(LinearConstraintBase):
    """Time symmetry: even ``v_t = v_{N-1-t}`` or odd ``v_t = −v_{N-1-t}`` on
    chosen components, optional even Δt symmetry."""

    name: str
    component_indices: tuple
    even: bool = True
    include_timestep: bool = False
    label: str = "symmetry constraint"

    @staticmethod
    def create(name, component_indices, *, even=True, include_timestep=False, label=None):
        return SymmetryConstraint(
            name=name, component_indices=tuple(int(i) for i in component_indices), even=even,
            include_timestep=include_timestep, label=label or f"symmetry constraint on {name}",
        )

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        N, dim = layout.N, layout.dim
        base = layout.comp_slice(self.name).start
        sign = -1.0 if self.even else 1.0
        pairs = [(t * dim + base + c, (N - 1 - t) * dim + base + c, sign)
                 for t in range(N // 2) for c in self.component_indices]
        if self.include_timestep and layout.has_free_time:
            dt_comp = layout.comp_slice(layout.timestep).start
            pairs += [(t * dim + dt_comp, (N - 1 - t) * dim + dt_comp, -1.0) for t in range(N // 2)]
        n_rows = len(pairs)
        rows = np.repeat(np.arange(n_rows), 2)
        cols = np.array([[p[0], p[1]] for p in pairs]).reshape(-1)
        vals = torch.tensor([[1.0, p[2]] for p in pairs], dtype=torch.float64).reshape(-1)
        canon.add_eq_rows(rows, cols, vals, np.zeros(n_rows), n_rows)


def SymmetricControlConstraint(name, idx, *, even=True, include_timestep=True, label=None):
    """Symmetry on control components."""
    return SymmetryConstraint.create(name, idx, even=even, include_timestep=include_timestep,
                                     label=label)


@module
class TimeConsistencyConstraint(LinearConstraintBase):
    """``t_{k+1} = t_k + Δt_k`` rows (promotable into the Riccati core)."""

    time_name: str = "t"
    timestep_name: str | None = None
    label: str = "time consistency constraint"

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        N, dim = layout.N, layout.dim
        t_comp = layout.comp_slice(self.time_name).start
        dt_comp = layout.comp_slice(self.timestep_name or _resolve_timestep_name(layout, None)).start
        n_rows = N - 1
        ks = np.arange(n_rows)
        rows = np.repeat(ks, 3)
        cols = np.stack([(ks + 1) * dim + t_comp, ks * dim + t_comp, ks * dim + dt_comp],
                        axis=1).reshape(-1)
        vals = np.tile(np.asarray([1.0, -1.0, -1.0]), n_rows)
        canon.add_eq_rows(rows, cols, vals, np.zeros(n_rows), n_rows)


@module
class L1SlackConstraint(LinearConstraintBase):
    """``|v| ≤ s`` via two inequality rows per component per knot."""

    var_name: str
    slack_name: str
    times: tuple | None = None
    label: str = "L1 slack constraint"

    @staticmethod
    def create(var_name, slack_name, traj, *, times=None, label=None):
        if traj.dims[var_name] != traj.dims[slack_name]:
            raise ValueError(f"dimension mismatch: {var_name} ({traj.dims[var_name]}) vs "
                             f"{slack_name} ({traj.dims[slack_name]})")
        return L1SlackConstraint(
            var_name=var_name, slack_name=slack_name,
            times=None if times is None else tuple(int(t) for t in times),
            label=label or f"L1 slack constraint: |{var_name}| <= {slack_name}",
        )

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        times = self.times if self.times is not None else tuple(range(layout.N))
        v_idx, _ = _z_indices(layout, self.var_name, times)
        s_idx, _ = _z_indices(layout, self.slack_name, times)
        n = len(v_idx)
        # rows [v − s ≤ 0 ; −v − s ≤ 0] interleaved
        rows = np.repeat(np.arange(2 * n), 2)
        pair = np.stack([v_idx, s_idx], axis=1)
        cols = np.stack([pair, pair], axis=1).reshape(-1)
        vals = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=torch.float64).repeat(n)
        canon.add_ineq_rows(rows, cols, vals, np.zeros(2 * n), 2 * n)


@module
class GlobalLinearConstraint(LinearConstraintBase):
    """``lb ≤ A·g ≤ ub`` on a global component: rows with lb == ub are
    equalities, ±inf sides are skipped, and an all-zero row that cannot be
    satisfied raises at construction. ``A`` is shared by the lanes, as
    static numpy (n_rows, dim), or per lane, as a (B, n_rows, dim) tensor
    (the JAX package's A under vmap); ``lb`` / ``ub`` are (B, n_rows). The
    row classification is taken from the host values at construction."""

    A: np.ndarray | torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    name: str
    label: str = "global linear constraint"
    eq_mask: tuple = ()
    finite_lb: tuple = ()
    finite_ub: tuple = ()

    @staticmethod
    def create(name, A, lb, ub=None, *, traj, label=None):
        """``traj`` gives the lane count, device and dtype of ``lb`` / ``ub``
        and of a per-lane ``A`` (a (B, n_rows, dim) tensor)."""
        per_lane = isinstance(A, torch.Tensor) and A.ndim == 3
        A_host = (A.detach().cpu().numpy() if isinstance(A, torch.Tensor)
                  else np.asarray(A)).astype(np.float64)
        lb = np.asarray(lb, dtype=np.float64).reshape(-1)
        ub = lb.copy() if ub is None else np.asarray(ub, dtype=np.float64).reshape(-1)
        if per_lane and A_host.shape[0] != traj.B:
            raise ValueError(f"a per-lane A has {A_host.shape[0]} lanes, the trajectory {traj.B}")
        if not (A_host.shape[-2] == len(lb) == len(ub)):
            raise ValueError("row count mismatch between A, lb, ub")
        if not np.all(lb <= ub):
            raise ValueError("lb must be elementwise <= ub")
        eq_mask = tuple(bool(lo == hi) for lo, hi in zip(lb, ub))
        for a in A_host.reshape(-1, *A_host.shape[-2:]):
            for r in range(a.shape[0]):
                if not np.any(a[r]) and ((eq_mask[r] and lb[r] != 0.0) or lb[r] > 0.0
                                         or ub[r] < 0.0):
                    raise ValueError(f"infeasible all-zero row {r} in {name} constraint")
        if per_lane:
            ref = traj.data[traj.names[0]]
            A = A.to(dtype=ref.dtype, device=ref.device)
        else:
            A = A_host
        return GlobalLinearConstraint(
            A=A, lb=_lane_values(lb, traj), ub=_lane_values(ub, traj), name=name,
            label=label or f"global linear constraint on {name}", eq_mask=eq_mask,
            finite_lb=tuple(bool(np.isfinite(v)) for v in lb),
            finite_ub=tuple(bool(np.isfinite(v)) for v in ub),
        )

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        gs = layout.global_z_slice(self.name)
        g_cols = np.arange(gs.start, gs.stop)
        n_rows, g_dim = self.A.shape[-2:]
        if isinstance(self.A, torch.Tensor):  # per lane: (B, nnz) values

            def take(r, sign=1.0):
                return sign * self.A[:, r].reshape(self.A.shape[0], -1)

            def join(a, b):
                return torch.cat([a, b], dim=1)
        else:

            def take(r, sign=1.0):
                return sign * self.A[r].reshape(-1)

            def join(a, b):
                return np.concatenate([a, b])
        finite_lb = self.finite_lb or (True,) * n_rows
        finite_ub = self.finite_ub or (True,) * n_rows
        eq_r = [r for r in range(n_rows) if self.eq_mask[r]]
        if eq_r:
            canon.add_eq_rows(np.repeat(np.arange(len(eq_r)), g_dim), np.tile(g_cols, len(eq_r)),
                              take(eq_r), self.lb[:, eq_r], len(eq_r))
        # a·g ≤ ub and −a·g ≤ −lb for the finite sides
        up_r = [r for r in range(n_rows) if not self.eq_mask[r] and finite_ub[r]]
        lo_r = [r for r in range(n_rows) if not self.eq_mask[r] and finite_lb[r]]
        n_in = len(up_r) + len(lo_r)
        if n_in:
            vals = join(take(up_r), take(lo_r, -1.0))
            rhs = torch.cat([self.ub[:, up_r], -self.lb[:, lo_r]], dim=1)
            canon.add_ineq_rows(np.repeat(np.arange(n_in), g_dim), np.tile(g_cols, n_in), vals,
                                rhs, n_in)
