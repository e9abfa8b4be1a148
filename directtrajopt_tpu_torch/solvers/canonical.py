"""Problem canonicalization: lower a problem into batched NLP callables.

Counterpart of ``directtrajopt_tpu/solvers/canonical.py``:

    min  f(Z)
    s.t. c_eq(Z) = 0      [dynamics ; affine rows A_eq Z − b_eq ; nonlinear eq]
         c_in(Z) ≤ 0      [affine rows A_in Z − b_in ; nonlinear ineq]
         lb ≤ Z ≤ ub      (±inf where unbounded)
         Z[fix_idx] = fix_val   (pins, handled by projection)

Every callable takes ``Z`` of shape ``(B, ..., z_dim)`` — one row per lane,
with optional extra axes (the line search's trial grid) that broadcast
against the per-lane problem data — and returns ``(B, ..., ·)``. Z's first
N·dim columns are the knots (seen as a ``(B, ..., N, dim)`` view, no copy)
and its last ``global_dim`` the global block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constraints.base import LinearCanon, NonlinearConstraintBase
from ..integrators.base import stack_residuals, stack_residuals_l1
from ..objectives.base import lane_data, objective_total
from ..precision import lane_sum
from ..problem import DirectTrajOptProblem
from ..trajectory import Layout

__all__ = ["COORows", "CanonicalNLP", "make_nlp", "index_add_ordered"]


def index_add_ordered(out: torch.Tensor, dim: int, index, src: torch.Tensor) -> torch.Tensor:
    """``out.index_add(dim, index, src)`` for a static index (a numpy array)
    whose repeated entries add up in the order they appear: one pass for
    each repeat, each adding at most one entry to a position. On the card
    ``index_add`` adds repeated indices by atomics, in no fixed order, so
    ``out + a + b`` could round as ``out + b + a`` from one launch to the
    next; the passes give every launch, on either device, the CPU's
    sequential sums."""
    index = np.asarray(index, dtype=np.int64)
    if len(index) == 0:
        return out
    order = np.argsort(index, kind="stable")
    first = np.searchsorted(index[order], index[order], side="left")
    rank = np.empty_like(index)
    rank[order] = np.arange(len(index)) - first  # earlier entries at the same position
    dev = out.device
    if rank.max() == 0:
        return out.index_add(dim, torch.as_tensor(index, device=dev), src)
    for r in range(int(rank.max()) + 1):
        sel = np.nonzero(rank == r)[0]
        out = out.index_add(dim, torch.as_tensor(index[sel], device=dev),
                            src.index_select(dim, torch.as_tensor(sel, device=src.device)))
    return out


@dataclass
class COORows:
    """Affine rows ``A Z`` in static-sparsity COO form; ``vals`` (B, nnz)."""

    rows: np.ndarray
    cols: np.ndarray
    vals: torch.Tensor
    n_rows: int
    n_cols: int

    def matvec(self, Z: torch.Tensor) -> torch.Tensor:
        """``A Z`` for Z (B, ..., n_cols)."""
        out = Z.new_zeros(Z.shape[:-1] + (self.n_rows,))
        if len(self.rows) == 0:
            return out
        v = lane_data(self.vals, Z[..., None, :]) * Z[..., self.cols]
        return index_add_ordered(out, -1, self.rows, v)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """``Aᵀ y`` for y (B, n_rows)."""
        out = y.new_zeros(y.shape[:-1] + (self.n_cols,))
        if len(self.rows) == 0:
            return out
        v = self.vals * y[:, self.rows]
        return index_add_ordered(out, -1, self.cols, v)

    def select_rows(self, idx: np.ndarray) -> torch.Tensor:
        """Dense (B, len(idx), n_cols) block of the selected rows (the Riccati
        border, whose row count does not grow with N)."""
        idx = np.asarray(idx, dtype=np.int64)
        B = self.vals.shape[0]
        out = self.vals.new_zeros((B, len(idx), self.n_cols))
        keep = np.isin(self.rows, idx)
        if not keep.any():
            return out
        remap = np.zeros(self.n_rows, dtype=np.int64)
        remap[idx] = np.arange(len(idx))
        flat = remap[self.rows[keep]] * self.n_cols + self.cols[keep]
        sel = self.vals[:, torch.as_tensor(np.nonzero(keep)[0], device=out.device)]
        return index_add_ordered(out.reshape(B, -1), 1, flat, sel).reshape(out.shape)

    def dense(self, dtype) -> torch.Tensor:
        """Full dense (B, n_rows, n_cols) materialization (the dense backend's
        assembly). Repeated (row, col) entries add up in the order they
        appear (:func:`index_add_ordered`)."""
        B = self.vals.shape[0]
        out = self.vals.new_zeros((B, self.n_rows * self.n_cols), dtype=dtype)
        flat = self.rows * self.n_cols + self.cols
        out = index_add_ordered(out, 1, flat, self.vals.to(dtype))
        return out.reshape(B, self.n_rows, self.n_cols)


@dataclass
class CanonicalNLP:
    """Batched NLP view of a problem."""

    layout: Layout
    z_dim: int
    n_dyn: int
    n_lin_eq: int
    n_lin_in: int
    fix_idx: np.ndarray  # static, unique
    fix_val: torch.Tensor  # (B, n_fix)
    free_mask: torch.Tensor  # (z_dim,) 1 where free, 0 where pinned
    pin_dense: torch.Tensor  # (B, z_dim) pin values, 0 where free
    lb: torch.Tensor  # (B, z_dim)
    ub: torch.Tensor
    A_eq: COORows
    b_eq: torch.Tensor
    A_in: COORows
    b_in: torch.Tensor
    integrators: tuple
    objective_obj: object
    eq_cons: tuple = ()  # nonlinear equality constraints
    in_cons: tuple = ()  # nonlinear inequality constraints
    # raw COO contributions of the linear constraints (static sparsity), for
    # the Riccati backend's structure analysis
    eq_entries: tuple = ()
    in_entries: tuple = ()
    n_nl_eq: int = 0
    n_nl_in: int = 0

    @property
    def n_eq(self) -> int:
        return self.n_dyn + self.n_lin_eq + self.n_nl_eq

    @property
    def n_in(self) -> int:
        return self.n_lin_in + self.n_nl_in

    def _zmat(self, Z: torch.Tensor) -> torch.Tensor:
        L = self.layout
        return Z[..., : L.N * L.dim].reshape(Z.shape[:-1] + (L.N, L.dim))

    def _gvec(self, Z: torch.Tensor) -> torch.Tensor:
        L = self.layout
        return Z[..., L.N * L.dim :]

    def objective(self, Z: torch.Tensor) -> torch.Tensor:
        return objective_total(self.objective_obj, self.layout, self._zmat(Z), self._gvec(Z))

    def dynamics(self, Z: torch.Tensor) -> torch.Tensor:
        zmat = self._zmat(Z)
        parts = [
            stack_residuals(integ, self.layout, zmat).reshape(Z.shape[:-1] + (-1,))
            for integ in self.integrators
        ]
        return torch.cat(parts, dim=-1) if parts else Z.new_zeros(Z.shape[:-1] + (0,))

    def _nl(self, cons, Z: torch.Tensor) -> torch.Tensor:
        zmat, g = self._zmat(Z), self._gvec(Z)
        return torch.cat([c.evaluate_flat(self.layout, zmat, g) for c in cons], dim=-1)

    def _lin(self, A: COORows, b: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
        return A.matvec(Z) - lane_data(b, Z[..., None, :])

    def c_eq(self, Z: torch.Tensor) -> torch.Tensor:
        parts = [self.dynamics(Z)]
        if self.n_lin_eq:
            parts.append(self._lin(self.A_eq, self.b_eq, Z))
        if self.n_nl_eq:
            parts.append(self._nl(self.eq_cons, Z))
        return torch.cat(parts, dim=-1)

    def c_eq_l1(self, Z: torch.Tensor) -> torch.Tensor:
        """``Σ|c_eq(Z)|`` without materializing the dynamics residuals
        (the bilinear integrator reduces inside its kernel)."""
        zmat = self._zmat(Z)
        tot = Z.new_zeros(Z.shape[:-1])
        for integ in self.integrators:
            tot = tot + stack_residuals_l1(integ, self.layout, zmat)
        if self.n_lin_eq:
            tot = tot + lane_sum(self._lin(self.A_eq, self.b_eq, Z).abs())
        if self.n_nl_eq:
            tot = tot + lane_sum(self._nl(self.eq_cons, Z).abs())
        return tot

    def c_in(self, Z: torch.Tensor) -> torch.Tensor:
        parts = []
        if self.n_lin_in:
            parts.append(self._lin(self.A_in, self.b_in, Z))
        if self.n_nl_in:
            parts.append(self._nl(self.in_cons, Z))
        return torch.cat(parts, dim=-1) if parts else Z.new_zeros(Z.shape[:-1] + (0,))

    def apply_pins(self, Z: torch.Tensor) -> torch.Tensor:
        """Overwrite pinned coordinates with their fixed values."""
        if len(self.fix_idx) == 0:
            return Z
        return Z * self.free_mask + lane_data(self.pin_dense, Z[..., None, :])


def _build_rows(entries, B: int, z_dim: int, kw) -> tuple[COORows, torch.Tensor, int]:
    """One concatenated COO block (rows offset per contribution) and its rhs."""
    n_rows = sum(e[4] for e in entries)
    if not entries:
        empty = np.zeros(0, np.int64)
        return COORows(empty, empty, torch.zeros((B, 0), **kw), 0, z_dim), \
            torch.zeros((B, 0), **kw), 0
    rows, cols, vals, rhs = [], [], [], []
    off = 0
    for r, c, v, b, n in entries:
        rows.append(np.asarray(r) + off)
        cols.append(np.asarray(c))
        vals.append(torch.as_tensor(v).to(**kw).expand(B, -1))
        rhs.append(b.to(**kw))
        off += n
    A = COORows(rows=np.concatenate(rows), cols=np.concatenate(cols),
                vals=torch.cat(vals, dim=1).contiguous(), n_rows=n_rows, n_cols=z_dim)
    return A, torch.cat(rhs, dim=1), n_rows


def make_nlp(problem: DirectTrajOptProblem) -> CanonicalNLP:
    """Lower a problem to canonical NLP form."""
    traj = problem.trajectory
    layout = traj.layout
    z_dim = layout.z_dim
    B = traj.B
    ref = traj.data[traj.names[0]]
    kw = dict(dtype=ref.dtype, device=ref.device)

    canon = LinearCanon(z_dim=z_dim, B=B)
    nl_cons = []
    for con in problem.constraints:
        if isinstance(con, NonlinearConstraintBase):
            nl_cons.append(con)
        else:
            con.lower(layout, canon)

    if canon.fix_idx:
        all_idx = np.concatenate(canon.fix_idx)
        uniq, inverse = np.unique(all_idx, return_inverse=True)
        fix_val = torch.zeros((B, len(uniq)), **kw)
        pos = 0
        for idx_arr, val_arr in zip(canon.fix_idx, canon.fix_val):
            n = len(idx_arr)  # later contributions override earlier ones
            fix_val[:, torch.as_tensor(inverse[pos : pos + n], device=ref.device)] = val_arr.to(**kw)
            pos += n
        fix_idx = uniq
    else:
        fix_idx = np.zeros((0,), dtype=np.int64)
        fix_val = torch.zeros((B, 0), **kw)
    fi = torch.as_tensor(fix_idx, device=ref.device)

    free_mask = torch.ones((z_dim,), **kw)
    free_mask[fi] = 0.0
    pin_dense = torch.zeros((B, z_dim), **kw)
    pin_dense[:, fi] = fix_val

    lb = torch.full((B, z_dim), -float("inf"), **kw)
    ub = torch.full((B, z_dim), float("inf"), **kw)
    for idx, val in zip(canon.lb_idx, canon.lb_val):
        ii = torch.as_tensor(idx, device=ref.device)
        lb[:, ii] = torch.maximum(lb[:, ii], val.to(**kw))
    for idx, val in zip(canon.ub_idx, canon.ub_val):
        ii = torch.as_tensor(idx, device=ref.device)
        ub[:, ii] = torch.minimum(ub[:, ii], val.to(**kw))
    lb[:, fi] = -float("inf")
    ub[:, fi] = float("inf")

    A_eq, b_eq, n_lin_eq = _build_rows(canon.eq_rows, B, z_dim, kw)
    A_in, b_in, n_lin_in = _build_rows(canon.ineq_rows, B, z_dim, kw)
    n_dyn = sum(i.residual_dim(layout) for i in problem.integrators) * (layout.N - 1)
    eq_cons = tuple(c for c in nl_cons if c.equality)
    in_cons = tuple(c for c in nl_cons if not c.equality)

    return CanonicalNLP(
        layout=layout, z_dim=z_dim, n_dyn=n_dyn, n_lin_eq=n_lin_eq, n_lin_in=n_lin_in,
        fix_idx=fix_idx, fix_val=fix_val, free_mask=free_mask, pin_dense=pin_dense,
        lb=lb, ub=ub, A_eq=A_eq, b_eq=b_eq, A_in=A_in, b_in=b_in,
        integrators=tuple(problem.integrators), objective_obj=problem.objective,
        eq_cons=eq_cons, in_cons=in_cons,
        eq_entries=tuple(canon.eq_rows), in_entries=tuple(canon.ineq_rows),
        n_nl_eq=sum(c.constraint_dim(layout) for c in eq_cons),
        n_nl_in=sum(c.constraint_dim(layout) for c in in_cons),
    )
