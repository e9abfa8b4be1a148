"""The port's bilinear window Jacobians and residual chains (plain PyTorch
versions of the CUDA kernels) against the JAX package.

f64: against ``_window_jac_xla`` / ``_res_xla`` to 1e-12. f32: against the
Pallas kernels in interpret mode to atol 2e-6, the bound
``tests/test_expv_kernel.py`` puts on the Pallas kernels themselves.
Includes the L1 form and batch sizes that are not multiples of anything.
The residual chain takes the trial grid (P problems, T slots) as strided
views of the knot matrix, as ``BilinearIntegrator._trial_views`` gives them.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directtrajopt_tpu.ops.expv_kernel import (
    _res_pallas,
    _res_xla,
    _window_jac_pallas,
    _window_jac_xla,
    make_residual_l1,
)
from directtrajopt_tpu_torch.integrators.bilinear import BilinearIntegrator
from directtrajopt_tpu_torch.ops import expv_kernel as tek
from directtrajopt_tpu_torch.trajectory import Layout

torch.set_num_threads(1)


def _inputs(seed, B, K, xd, n_dr, dtype, with_xn=False):
    rng = np.random.default_rng(seed)
    arrs = [
        rng.normal(size=(B, xd, xd)),
        rng.normal(size=(B, n_dr, xd, xd)),
        0.3 * rng.normal(size=(B, K, n_dr)),
        0.1 + 0.05 * rng.random((B, K)),
        rng.normal(size=(B, K, xd)),
    ]
    if with_xn:
        arrs.append(rng.normal(size=(B, K, xd)))
    return [a.astype(dtype) for a in arrs]


def _t(arrs):
    return [torch.as_tensor(a) for a in arrs]


def _one_slot(arrs):
    """Flat (B, K, ·) residual inputs as a trial grid of B problems × 1 slot."""
    return [torch.as_tensor(a if i < 2 else a[:, None]) for i, a in enumerate(arrs)]


@pytest.mark.parametrize("free_time", [True, False])
@pytest.mark.parametrize("B,K,xd,n_dr,order", [(5, 50, 4, 2, 6), (3, 7, 3, 1, 12)])
def test_window_jac_f64_matches_xla(free_time, B, K, xd, n_dr, order):
    args = _inputs(0, B, K, xd, n_dr, np.float64)
    ref = jax.vmap(lambda *a: _window_jac_xla(order, free_time, *a))(*map(jnp.asarray, args))
    out = tek.window_jac(order, free_time, *_t(args))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12, rtol=0)


@pytest.mark.parametrize("free_time", [True, False])
@pytest.mark.parametrize("B", [5, 130])
def test_window_jac_f32_matches_pallas_interpret(free_time, B):
    args = _inputs(1, B, 50, 4, 2, np.float32)
    # generators of unit scale, as the benchmark's Pauli generators are (the
    # absolute bound presumes Jacobian entries of order one)
    args[0] *= 0.5
    args[1] *= 0.5
    ref = _window_jac_pallas(6, free_time, *map(jnp.asarray, args), interpret=True)
    out = tek.window_jac(6, free_time, *_t(args))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6, rtol=0)


@pytest.mark.parametrize("B,K,xd,n_dr", [(7, 50, 4, 2), (3, 5, 2, 1)])
def test_residual_f64_matches_xla(B, K, xd, n_dr):
    args = _inputs(2, B, K, xd, n_dr, np.float64, with_xn=True)
    ref = jax.vmap(lambda *a: _res_xla(6, *a))(*map(jnp.asarray, args))
    out = tek.residual_action(6, *_one_slot(args))
    assert out.shape == (B, 1, K, xd)
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(ref), atol=1e-12, rtol=0)
    l1 = tek.residual_l1(6, *_one_slot(args))
    assert l1.shape == (B, 1)
    np.testing.assert_allclose(
        l1[:, 0].numpy(), np.asarray(jnp.sum(jnp.abs(ref), axis=(-2, -1))), atol=1e-12, rtol=0
    )


@pytest.mark.parametrize("B", [7, 9 * 3])
def test_residual_f32_matches_pallas_interpret(B):
    """B problems with one slot each (the trial grid is in
    ``test_trial_grid_views_f32_matches_pallas_and_jax_l1``)."""
    args = _inputs(3, B, 50, 4, 2, np.float32, with_xn=True)
    ref = np.asarray(_res_pallas(6, *map(jnp.asarray, args), interpret=True))
    out = tek.residual_action(6, *_one_slot(args))[:, 0]
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=0)
    l1 = tek.residual_l1(6, *_one_slot(args))[:, 0].numpy()
    np.testing.assert_allclose(l1, np.abs(ref).sum(axis=(-2, -1)), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("B", [130])
def test_state_constrained_shape_f32_matches_pallas_interpret(B):
    """x_dim 2 with 1 drive at a fixed Δt (the state-constrained family's
    shape: a 2×3 Jacobian block per window), window Jacobian and both
    residual forms, Taylor order 12."""
    args = _inputs(5, B, 50, 2, 1, np.float32, with_xn=True)
    args[0] *= 0.5
    args[1] *= 0.5
    jargs = list(map(jnp.asarray, args))
    ref = _window_jac_pallas(12, False, *jargs[:5], interpret=True)
    out = tek.window_jac(12, False, *_t(args[:5]))
    assert out.shape == (B, 50, 2, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6, rtol=0)
    ref_r = np.asarray(_res_pallas(12, *jargs, interpret=True))
    np.testing.assert_allclose(tek.residual_action(12, *_one_slot(args))[:, 0].numpy(), ref_r,
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(tek.residual_l1(12, *_one_slot(args))[:, 0].numpy(),
                               np.abs(ref_r).sum(axis=(-2, -1)), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("xd,nd", [(3, 1), (6, 2), (8, 2)])
def test_size_class_shapes_f32_match_jax(xd, nd):
    """The plain K3/K4 at shapes of the size-class kernels, float32, Taylor
    order 6, free and fixed Δt, 4 lanes × 5 windows: K4 (both forms)
    against the Pallas kernel in interpret mode to 2e-6 (the L1 form
    relative to max(Σ|r|, 1)), K3 against it at (3,1) and against its
    float32 XLA version (``_window_jac_xla``, which the JAX package's tests
    hold the Pallas kernel to) at x_dim 6 and 8, where the Pallas
    interpreter takes 15 s to 2 minutes to trace K3 on the CPU."""
    args = _inputs(xd + 10 * nd, 4, 5, xd, nd, np.float32, with_xn=True)
    args[0] *= 0.5
    args[1] *= 0.5
    jargs = list(map(jnp.asarray, args))
    for free in (True, False):
        if xd < 6:
            ref = _window_jac_pallas(6, free, *jargs[:5], interpret=True)
        else:
            ref = jax.vmap(lambda *a, f=free: _window_jac_xla(6, f, *a))(*jargs[:5])
        out = tek.window_jac(6, free, *_t(args[:5]))
        assert out.shape == (4, 5, xd, xd + nd + free)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6, rtol=0)
    ref_r = np.asarray(_res_pallas(6, *jargs, interpret=True))
    np.testing.assert_allclose(tek.residual_action(6, *_one_slot(args))[:, 0].numpy(), ref_r,
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(tek.residual_l1(6, *_one_slot(args))[:, 0].numpy(),
                               np.abs(ref_r).sum(axis=(-2, -1)), rtol=2e-6, atol=2e-6)


def test_size_class_choice_matches_the_kernel_source():
    """``size_class`` is the C entries' choice: ``expv_classed.cu`` tries
    the classes of ``SIZE_CLASSES`` in order, each launching its own
    instantiation, and a shape takes the first that holds it; every shape
    within the caps has one, none beyond them. The exact shapes take
    their own kernels (``design``); the size-class kernels skip terms by
    selects, with no ``break`` in the source."""
    from directtrajopt_tpu_torch.ops import _build

    src = (Path(tek.__file__).parent.parent / "csrc" / "expv_classed.cu").read_text()
    for launcher in ("launch_jac_c", "launch_res_l1"):
        found = re.findall(rf"if \(xd <= (\d+) && nd <= (\d+)\)\s*return {launcher}<(\d+), (\d+)>",
                           src)
        assert all(f[:2] == f[2:] for f in found)
        assert tuple(tuple(map(int, f[:2])) for f in found) == tek.SIZE_CLASSES
    assert "break;" not in src and src.count("__global__") == 2
    caps = _build.EXPV_CAPS
    for xd in range(1, caps["xd"] + 1):
        for nd in range(caps["nd"] + 1):
            want = next(c for c in tek.SIZE_CLASSES if xd <= c[0] and nd <= c[1])
            assert tek.size_class(xd, nd) == want
            assert tek.design(xd, nd) == ("exact" if (xd, nd) in tek.SUPPORTED_SHAPES
                                          else "classed")
    assert tek.size_class(8, 2) == (8, 2) and tek.size_class(6, 2) == (6, 2)
    assert tek.size_class(7, 1) == (8, 2) and tek.size_class(5, 0) == (6, 2)
    assert tek.size_class(3, 1) == (4, 2) and tek.size_class(8, 8) == (8, 8)
    for bad in ((9, 2), (0, 1), (4, 9)):
        with pytest.raises(ValueError):
            tek.size_class(*bad)


def test_size_class_launches_are_counted_by_kernel(monkeypatch):
    """On the card a size-class launch counts under the wrapper's
    ``*_generic`` key and, in ``_build.INSTANCES``, under its CUDA kernel's
    name; an exact launch only under its own key. (A stand-in library
    answers the C entries here, where nothing can launch.)"""
    from directtrajopt_tpu_torch.ops import _build

    class Lib:
        @staticmethod
        def dto_window_jac(*a):
            return 0

        @staticmethod
        def dto_residual(*a):
            return 0

    monkeypatch.setattr(_build, "route", lambda *a: "kernel")
    monkeypatch.setattr(_build, "library", lambda: Lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    _build.reset_launches()
    try:
        for xd, nd in ((8, 2), (3, 1), (4, 2)):
            Gd, Gv, u, dt, x, xn = _one_slot(_inputs(0, 2, 3, xd, nd, np.float32, with_xn=True))
            tek.window_jac_zk(6, Gd, Gv, u, dt, x, (0, xd, xd + nd), xd + nd + 1)
            tek.residual_action(6, Gd, Gv, u, dt, x, xn)
            tek.residual_l1(6, Gd, Gv, u, dt, x, xn)
        launches, instances = dict(_build.LAUNCHES), dict(_build.INSTANCES)
    finally:
        _build.reset_launches()
    assert launches == dict(factor_solve=0, resolve=0, window_jac=1, residual=1, residual_l1=1,
                            window_jac_generic=2, residual_generic=2, residual_l1_generic=2)
    assert instances == {"window_jac_classed<8,2>": 1, "residual_classed<8,2,0>": 1,
                         "residual_classed<8,2,1>": 1, "window_jac_classed<4,2>": 1,
                         "residual_classed<4,2,0>": 1, "residual_classed<4,2,1>": 1}


def test_kernel_wrapper_rejects_uninstantiated_shapes_only_on_cuda():
    """On the CPU every shape takes the plain version; the exact kernel
    instantiations are the benchmark's (x_dim=4, 2 drives) and the
    state-constrained family's (x_dim=2, 1 drive). On the card no shape
    within the caps is rejected any more: the others take the generic
    kernel, and only x_dim or n_drives beyond 8 take the plain version."""
    from directtrajopt_tpu_torch.ops import _build

    args = _inputs(4, 2, 3, 5, 2, np.float32)
    assert tek.window_jac(4, True, *_t(args)).shape == (2, 3, 5, 8)
    assert tek.SUPPORTED_SHAPES == {(4, 2), (2, 1)}
    for (xd, nd), want in (((5, 2), "kernel"), ((8, 8), "kernel"), ((9, 2), "plain")):
        assert _build.route("expv", "cuda", torch.float32, dict(xd=xd, nd=nd)) == want
        assert tek._launch_key("residual", xd, nd) == "residual_generic"


# the two shapes of the paths: path 1's 4-D state, 2 drives and a free Δt in
# an 11-wide knot (x, u, du, ddu, dt), order 6; path 2's 2-D state, 1 drive,
# a fixed Δt of 0.15, order 12
GRID_SHAPES = {
    "x4u2_free_dt": dict(xd=4, nd=2, order=6, names=("x", "u", "du", "ddu", "dt"),
                         dims=(4, 2, 2, 2, 1), timestep="dt"),
    "x2u1_fixed_dt": dict(xd=2, nd=1, order=12, names=("x", "u"), dims=(2, 1),
                          timestep=0.15),
}


# the window Jacobian also at each shape's other kind of Δt
JAC_SHAPES = dict(
    GRID_SHAPES,
    x4u2_fixed_dt=dict(GRID_SHAPES["x4u2_free_dt"], names=("x", "u", "du", "ddu"),
                       dims=(4, 2, 2, 2), timestep=0.1),
    x2u1_free_dt=dict(GRID_SHAPES["x2u1_fixed_dt"], names=("x", "u", "dt"), dims=(2, 1, 1),
                      timestep="dt"),
)


def _grid(shape, P, T, N, seed):
    """A knot matrix (P, T, N, d) near a rollout of each problem's dynamics
    (residuals of 1e-3, as on a line search near feasibility), its layout
    and the per-problem generators (float64 numpy). The generators are
    skew-symmetric, as the benchmarks' are: the state keeps unit norm."""
    c = JAC_SHAPES[shape]
    xd, nd, order = c["xd"], c["nd"], c["order"]
    rng = np.random.default_rng(seed)
    lay = Layout(names=c["names"], dims=c["dims"], N=N, timestep=c["timestep"])
    Gd = 0.5 * rng.normal(size=(P, xd, xd))
    Gv = 0.5 * rng.normal(size=(P, nd, xd, xd))
    Gd, Gv = Gd - np.swapaxes(Gd, -1, -2), Gv - np.swapaxes(Gv, -1, -2)
    Z = rng.normal(size=(P, T, N, lay.dim))
    cs_x, cs_u = lay.comp_slice("x"), lay.comp_slice("u")
    Z[..., cs_u] *= 0.3
    if lay.has_free_time:
        Z[..., lay.offsets["dt"]] = 0.1 + 0.05 * rng.random((P, T, N))
    x = Z[:, :, 0, cs_x] / np.linalg.norm(Z[:, :, 0, cs_x], axis=-1, keepdims=True)
    for k in range(N - 1):
        Z[:, :, k, cs_x] = x
        h = Z[:, :, k, lay.offsets["dt"]] if lay.has_free_time else np.full((P, T), lay.timestep)
        A = h[..., None, None] * (Gd[:, None] + np.einsum("ptm,pmij->ptij", Z[:, :, k, cs_u], Gv))
        y = x
        for j in range(order, 0, -1):
            y = x + np.einsum("ptij,ptj->pti", A, y) / j
        x = y + 1e-3 * rng.normal(size=y.shape)
    Z[:, :, N - 1, cs_x] = x
    return Z, lay, Gd, Gv


def _views(Z, lay, Gd, Gv, dtype, order=12):
    integ = BilinearIntegrator.create((Gd, Gv), "x", "u", batch=Gd.shape[0], device="cpu",
                                      dtype=dtype, method="taylor", taylor_order=order)
    Zt = torch.as_tensor(Z, dtype=dtype)
    return integ, Zt, integ._trial_views(lay, Zt)


@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("shape", list(GRID_SHAPES))
def test_trial_grid_views_f64_matches_xla(shape, T):
    """Both forms on the (P, T, K) views against ``_res_xla`` per
    (problem, slot), f64, 1e-12."""
    order = GRID_SHAPES[shape]["order"]
    Z, lay, Gd, Gv = _grid(shape, 3, T, 51, seed=10 + T)
    _, _, v = _views(Z, lay, Gd, Gv, torch.float64)
    args = [np.asarray(a) for a in v]
    ref = jax.vmap(lambda gd, gv, u, dt, x, xn: jax.vmap(
        lambda *a: _res_xla(order, gd, gv, *a))(u, dt, x, xn))(*map(jnp.asarray, args))
    out = tek.residual_action(order, *v)
    assert out.shape == (3, T, 50, GRID_SHAPES[shape]["xd"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12, rtol=0)
    l1 = tek.residual_l1(order, *v)
    assert l1.shape == (3, T)
    np.testing.assert_allclose(l1.numpy(), np.abs(np.asarray(ref)).sum((-2, -1)),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("shape", list(GRID_SHAPES))
def test_trial_grid_views_f32_matches_pallas_and_jax_l1(shape, T):
    """f32, 2e-6 absolute: the vector form against ``_res_pallas`` in
    interpret mode on the flattened (problem × slot) lanes, and the L1 form
    against the JAX package's ``make_residual_l1`` under its production
    nesting (problems × trials, the Pallas chain in interpret mode)."""
    order = GRID_SHAPES[shape]["order"]
    P = 3
    Z, lay, Gd, Gv = _grid(shape, P, T, 51, seed=20 + T)
    integ, Zt, v = _views(Z, lay, Gd, Gv, torch.float32, order)
    gd, gv, u, dt, x, xn = (np.asarray(a) for a in v)
    flat = [np.repeat(gd, T, 0), np.repeat(gv, T, 0)] + [
        np.ascontiguousarray(a).reshape((P * T,) + a.shape[2:]) for a in (u, dt, x, xn)]
    ref = np.asarray(_res_pallas(order, *map(jnp.asarray, flat), interpret=True))
    out = tek.residual_action(order, *v)
    np.testing.assert_allclose(out.reshape(ref.shape).numpy(), ref, atol=2e-6, rtol=0)
    fn = make_residual_l1(order, "interpret")
    ref_l1 = jax.vmap(lambda g0, g1, uu, tt, xx, nn: jax.vmap(
        lambda *a: fn(g0, g1, *a))(uu, tt, xx, nn))(*map(jnp.asarray, (gd, gv, u, dt, x, xn)))
    l1 = tek.residual_l1(order, *v)
    np.testing.assert_allclose(l1.numpy(), np.asarray(ref_l1), atol=2e-6, rtol=0)
    # the integrator's entries reshape to the knot matrix's leading axes
    zt = Zt if T > 1 else Zt[:, 0]
    torch.testing.assert_close(integ.residuals_l1_stacked(lay, zt), l1.reshape(zt.shape[:-2]))
    torch.testing.assert_close(integ.residuals_stacked(lay, zt),
                               out.reshape(zt.shape[:-2] + (50, -1)))


@pytest.mark.parametrize("shape", list(GRID_SHAPES))
def test_trial_views_share_the_knot_matrix(shape):
    """The residual kernel's arguments are views of the knot matrix (no
    copy); a fixed Δt is one scalar expanded with stride 0."""
    Z, lay, Gd, Gv = _grid(shape, 2, 9, 7, seed=3)
    integ, Zt, (gd, gv, u, dt, x, xn) = _views(Z, lay, Gd, Gv, torch.float32)
    base = Zt.untyped_storage().data_ptr()
    for t in (u, x, xn) + ((dt,) if lay.has_free_time else ()):
        assert t.untyped_storage().data_ptr() == base
        assert t.shape[:3] == (2, 9, 6)
    assert gd is integ.G_drift and gv is integ.G_drives
    assert x.stride(-1) == u.stride(-1) == xn.stride(-1) == 1
    if not lay.has_free_time:
        assert dt.stride() == (0, 0, 0) and float(dt[1, 8, 5]) == pytest.approx(0.15)


def test_residual_instantiations_match_the_kernel_source():
    """The (x_dim, n_drives) pairs that ``dto_residual`` dispatches, each to
    both forms of ``residual_grid_kernel``, are ``SUPPORTED_SHAPES``; the
    L1 form is one kernel (no second pass)."""
    src = (Path(tek.__file__).parent.parent / "csrc" / "expv_kernel.cu").read_text()
    entry = src[src.index('extern "C" int dto_residual('):]
    entry = entry[: entry.index("\n}\n")]
    pairs = re.findall(r"if \(xd == (\d+) && nd == (\d+)\)\s*return l1 \? "
                       r"launch_res<(\d+), (\d+), true>.*?\s*: launch_res<(\d+), (\d+), false>",
                       entry)
    assert all(p[:2] == p[2:4] == p[4:] for p in pairs)
    assert {tuple(map(int, p[:2])) for p in pairs} == tek.SUPPORTED_SHAPES
    assert "lane_sum" not in src and src.count("__global__") == 2


def _jax_window_jac_zk(fn, order, Gd, Gv, Z, lay):
    """JAX's window Jacobians ``fn(order, free_time, Gd, Gv, u, dt, x)`` on
    the (problem × slot) lanes of a knot matrix Z (P, T, N, d), placed in z_k
    width as the JAX package's ``BilinearIntegrator.jacobians_zk`` places
    them: a product with a one-hot (n_th, d) matrix, negated."""
    P, T, N, d = Z.shape
    cs_x, cs_u = lay.comp_slice("x"), lay.comp_slice("u")
    free = lay.has_free_time
    dt = Z[:, :, :-1, lay.offsets["dt"]] if free else np.full((P, T, N - 1), lay.timestep, Z.dtype)

    def lanes(a):
        return jnp.asarray(np.ascontiguousarray(a).reshape((P * T,) + a.shape[2:]))

    J = fn(order, free, jnp.asarray(np.repeat(Gd, T, 0)), jnp.asarray(np.repeat(Gv, T, 0)),
           lanes(Z[:, :, :-1, cs_u]), lanes(dt), lanes(Z[:, :, :-1, cs_x]))
    cols = list(range(cs_x.start, cs_x.stop)) + list(range(cs_u.start, cs_u.stop))
    if free:
        cols.append(lay.offsets["dt"])
    Em = np.zeros((len(cols), d), Z.dtype)
    Em[np.arange(len(cols)), cols] = 1.0
    return np.asarray(-(J @ jnp.asarray(Em))).reshape(P, T, N - 1, -1, d)


@pytest.mark.parametrize("P,T", [(7, 1), (2, 3)])
@pytest.mark.parametrize("shape", list(JAC_SHAPES))
def test_window_jac_zk_views_f64_matches_xla(shape, P, T):
    """The d-wide window Jacobian on strided views of the knot matrix (the
    integrator's arguments) against ``_window_jac_xla`` placed in z_k width,
    f64, 1e-12; and the integrator's entry reshapes it to the knot matrix's
    leading axes."""
    order = JAC_SHAPES[shape]["order"]
    Z, lay, Gd, Gv = _grid(shape, P, T, 51, seed=30 + T)
    integ = BilinearIntegrator.create((Gd, Gv), "x", "u", batch=P, device="cpu",
                                      dtype=torch.float64, method="taylor", taylor_order=order)
    Zt = torch.as_tensor(Z)
    ref = _jax_window_jac_zk(lambda o, f, *a: jax.vmap(lambda *b: _window_jac_xla(o, f, *b))(*a),
                             order, Gd, Gv, Z, lay)
    out = tek.window_jac_zk(order, *integ._window_jac_args(lay, Zt))
    assert out.shape == (P, T, 50, JAC_SHAPES[shape]["xd"], lay.dim)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-12, rtol=0)
    zt = Zt if T > 1 else Zt[:, 0]
    assert torch.equal(integ.jacobians_zk_stacked(lay, zt), out.reshape(zt.shape[:-2] + out.shape[2:]))


@pytest.mark.parametrize("shape", list(JAC_SHAPES))
def test_window_jac_zk_views_f32_matches_pallas_interpret(shape):
    """f32, 2e-6 absolute, against ``_window_jac_pallas`` in interpret mode
    placed in z_k width, at 7 problems (a multiple of nothing)."""
    order = JAC_SHAPES[shape]["order"]
    Z, lay, Gd, Gv = _grid(shape, 7, 1, 51, seed=40)
    integ, Zt, _ = _views(Z, lay, Gd, Gv, torch.float32, order)
    ref = _jax_window_jac_zk(lambda *a: _window_jac_pallas(*a, interpret=True), order,
                             Gd.astype(np.float32), Gv.astype(np.float32), Z.astype(np.float32),
                             lay)
    out = tek.window_jac_zk(order, *integ._window_jac_args(lay, Zt))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", list(JAC_SHAPES))
def test_jacobians_zk_stacked_is_the_scatter_of_window_jac(shape, dtype):
    """``jacobians_zk_stacked`` equals zeros with −``window_jac_plain`` on
    contiguous per-lane copies placed at the columns of x, u and Δt, bit for
    bit (the port's entry before it wrote z_k width itself)."""
    c = JAC_SHAPES[shape]
    Z, lay, Gd, Gv = _grid(shape, 5, 1, 9, seed=50)
    integ = BilinearIntegrator.create((Gd, Gv), "x", "u", batch=5, device="cpu", dtype=dtype,
                                      method="taylor", taylor_order=c["order"])
    zm = torch.as_tensor(Z[:, 0], dtype=dtype)
    cs_x, cs_u = lay.comp_slice("x"), lay.comp_slice("u")
    x, u = zm[:, :-1, cs_x].contiguous(), zm[:, :-1, cs_u].contiguous()
    dt = lay.knot_timestep(zm[:, :-1]).contiguous()
    J = tek.window_jac_plain(c["order"], lay.has_free_time, integ.G_drift, integ.G_drives, u, dt,
                             x)
    cols = list(range(cs_x.start, cs_x.stop)) + list(range(cs_u.start, cs_u.stop))
    if lay.has_free_time:
        cols.append(lay.offsets["dt"])
    want = torch.zeros(J.shape[:-1] + (lay.dim,), dtype=dtype)
    want[..., cols] = -J
    got = integ.jacobians_zk_stacked(lay, zm)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("shape", list(JAC_SHAPES))
def test_window_jac_args_share_the_knot_matrix(shape):
    """The window-Jacobian kernel's arguments are views of the knot matrix
    (no copy, no x_next), the generators as they lie, and J's columns at the
    offsets of x, u and Δt in the knot."""
    Z, lay, Gd, Gv = _grid(shape, 2, 1, 7, seed=4)
    integ, Zt, _ = _views(Z, lay, Gd, Gv, torch.float32)
    zm = Zt[:, 0]
    gd, gv, u, dt, x, cols, d = integ._window_jac_args(lay, zm)
    base = zm.untyped_storage().data_ptr()
    for t in (u, x) + ((dt,) if lay.has_free_time else ()):
        assert t.untyped_storage().data_ptr() == base
        assert t.shape[:3] == (2, 1, 6)
    assert gd is integ.G_drift and gv is integ.G_drives
    assert x.stride(-1) == u.stride(-1) == 1
    assert d == lay.dim
    assert cols == (lay.offsets["x"], lay.offsets["u"],
                    lay.offsets["dt"] if lay.has_free_time else None)
    if not lay.has_free_time:
        assert dt.stride() == (0, 0, 0) and float(dt[1, 0, 5]) == pytest.approx(lay.timestep)


def test_window_jac_instantiations_match_the_kernel_source():
    """The (x_dim, n_drives) pairs that ``dto_window_jac`` dispatches are
    ``SUPPORTED_SHAPES``, each to ``launch_jac`` of the same pair, which
    launches the one kernel with one or two threads a window; the (L, K, ·)
    interface and the z_k-wide entry share it."""
    src = (Path(tek.__file__).parent.parent / "csrc" / "expv_kernel.cu").read_text()
    entry = src[src.index('extern "C" int dto_window_jac('):]
    entry = entry[: entry.index("\n}\n")]
    pairs = re.findall(r"if \(xd == (\d+) && nd == (\d+)\) return launch_jac<(\d+), (\d+)>", entry)
    assert all(p[:2] == p[2:] for p in pairs)
    assert {tuple(map(int, p[:2])) for p in pairs} == tek.SUPPORTED_SHAPES
    launches = re.findall(r"window_jac_kernel<XD, ND, (\d)><<<", src)
    assert sorted(launches) == ["1", "2"]
