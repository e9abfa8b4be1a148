"""The port's kernel routing over the Pallas kernels' whole shape range.

``_build.route`` against the JAX package's ``pallas_eligible`` (K1/K2) and
``window_jac_eligible`` (K3/K4), which add a VMEM budget the port does not
have; and the plain versions at the shapes the new kernel instantiations
take (the size-class K1/K2 up to n_s, n_v = 24; the generic K3/K4 up to
x_dim 8 with 8 drives) against the JAX package: f64 against its XLA
versions to 1e-10, f32 against the Pallas kernels in interpret mode to
2e-6 absolute (K3/K4) and the XLA version to 5e-6 relative (K1/K2). And
path 7e's problems (the scaling family at state_dim 4, K1/K2 at (6,3,·))
solved by the port in float64 against the JAX package's solve.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directtrajopt_tpu.ops import riccati_kernel as rk
from directtrajopt_tpu.ops.expv_kernel import (
    _res_pallas,
    _res_xla,
    _window_jac_pallas,
    _window_jac_xla,
    window_jac_eligible,
)
from directtrajopt_tpu_torch import benchmarks as tb
from directtrajopt_tpu_torch.ops import _build
from directtrajopt_tpu_torch.ops import expv_kernel as tek
from directtrajopt_tpu_torch.ops import riccati_kernel as trk
from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64

# (device type, dtype, sizes) -> route, both sides of each cap. N = 2 knots
# and K = 10 windows keep the JAX package's VMEM term from deciding.
RICCATI_TABLE = [
    ("cpu", F32, (8, 3, 3), "plain"),
    ("cpu", F64, (8, 3, 3), "plain"),
    ("cuda", F64, (8, 3, 3), "plain"),
    ("cuda", F32, (8, 3, 3), "kernel"),
    ("cuda", F32, (1, 1, 1), "kernel"),
    ("cuda", F32, (24, 24, 40), "kernel"),
    ("cuda", F32, (25, 3, 3), "plain"),
    ("cuda", F32, (3, 25, 3), "plain"),
    ("cuda", F32, (24, 24, 41), "plain"),
    ("cuda", F32, (18, 3, 3), "kernel"),
]
EXPV_TABLE = [
    ("cpu", F32, (4, 2), "plain"),
    ("cuda", F64, (4, 2), "plain"),
    ("cuda", F32, (4, 2), "kernel"),
    ("cuda", F32, (1, 1), "kernel"),
    ("cuda", F32, (8, 8), "kernel"),
    ("cuda", F32, (3, 0), "kernel"),
    ("cuda", F32, (9, 1), "plain"),
    ("cuda", F32, (3, 9), "plain"),
]


@pytest.mark.parametrize("dev,dtype,shape,want", RICCATI_TABLE)
def test_riccati_route_follows_the_caps(dev, dtype, shape, want):
    ns, nv, R = shape
    assert _build.route("riccati", dev, dtype, dict(ns=ns, nv=nv, R=R)) == want
    if dev == "cuda":
        jdt = jnp.float32 if dtype == F32 else jnp.float64
        assert rk.pallas_eligible(2, ns, nv, R, jdt) == (want == "kernel")


@pytest.mark.parametrize("dev,dtype,shape,want", EXPV_TABLE)
def test_expv_route_follows_the_caps(dev, dtype, shape, want):
    xd, nd = shape
    assert _build.route("expv", dev, dtype, dict(xd=xd, nd=nd)) == want
    if dev == "cuda":
        jdt = jnp.float32 if dtype == F32 else jnp.float64
        assert window_jac_eligible(10, xd, nd, jdt) == (want == "kernel")


@pytest.mark.parametrize("kind,sizes,jax_eligible", [
    ("riccati", dict(ns=18, nv=3, R=3), lambda: rk.pallas_eligible(51, 18, 3, 3, jnp.float32)),
    ("riccati", dict(ns=24, nv=24, R=8), lambda: rk.pallas_eligible(51, 24, 24, 8, jnp.float32)),
    ("expv", dict(xd=8, nd=8), lambda: window_jac_eligible(50, 8, 8, jnp.float32)),
])
def test_vmem_deciding_cases(kind, sizes, jax_eligible):
    """Where the JAX package's VMEM budget decides: the scaling family's
    (18,3,3) at N=51 (path 7b), the wide corner at N=51, and K3/K4 at (8,8)
    on 50 windows go to XLA on a TPU; the port, with no VMEM term, takes
    the kernel."""
    assert not jax_eligible()
    assert _build.route(kind, "cuda", F32, sizes) == "kernel"


def test_route_refuses_other_devices_and_dtypes():
    with pytest.raises(ValueError):
        _build.route("riccati", "mps", F32, dict(ns=2, nv=1, R=1))
    with pytest.raises(TypeError):
        _build.route("expv", "cuda", torch.float16, dict(xd=2, nd=1))
    with pytest.raises(ValueError):
        _build.route("other", "cuda", F32, {})


def test_cpu_plain_calls_are_not_counted():
    """A plain call on the CPU counts neither a launch nor a plain call:
    ``PLAIN_CALLS`` counts float32 calls on the card beyond the caps."""
    _build.reset_launches()
    args = _stage(0, B=2, N=3, ns=25, nv=2, R=2)
    trk.factor_solve(np.ones(25), *(torch.as_tensor(a, dtype=F32) for a in args))
    assert not any(_build.LAUNCHES.values()) and not any(_build.PLAIN_CALLS.values())


def _stage(seed, B, N, ns, nv, R):
    """Well-conditioned random stage stacks (tests/test_pallas_kkt.py's generator)."""
    rng = np.random.default_rng(seed)

    def sym(x):
        return 0.5 * (x + np.swapaxes(x, -1, -2))

    Qss = sym(rng.standard_normal((B, N, ns, ns))) * 0.1 + np.eye(ns) * 2.0
    Qsv = rng.standard_normal((B, N, ns, nv)) * 0.1
    Qvv = sym(rng.standard_normal((B, N, nv, nv))) * 0.1 + np.eye(nv) * 2.0
    A = rng.standard_normal((B, N, ns, ns)) * 0.3
    A[:, -1] = 0.0
    Bm = rng.standard_normal((B, N, ns, nv)) * 0.3
    Bm[:, -1] = 0.0
    qs = rng.standard_normal((B, R, N, ns))
    qv = rng.standard_normal((B, R, N, nv))
    b = rng.standard_normal((B, R, N, ns))
    b[:, :, -1] = 0.0
    return [Qss, Qsv, Qvv, A, Bm, qs, qv, b]


def _rel(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return np.max(np.abs(x - y)) / max(np.max(np.abs(x)), 1.0)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 5e-6)])
@pytest.mark.parametrize("ns,nv,R", [(18, 3, 3), (24, 24, 8)])
def test_wide_plain_matches_jax_xla(ns, nv, R, dtype, tol):
    """Plain K1 and K2 at the wide kernels' shapes against the JAX package's
    ``_factor_solve_xla`` and ``_resolve_xla``; the certificate equal."""
    s0m = np.ones(ns)
    s0m[:2] = 0.0
    args = [a.astype(dtype) for a in _stage(1, B=3, N=6, ns=ns, nv=nv, R=R)]
    ref = jax.vmap(lambda *a: rk._factor_solve_xla(s0m, *a))(*map(jnp.asarray, args))
    out = trk.factor_solve(s0m, *(torch.as_tensor(a) for a in args))
    for x, y in zip(ref, out):
        if y.dtype == torch.bool:
            assert (np.asarray(x) == y.numpy()).all()
        else:
            assert _rel(x, y.numpy()) < tol
    rhs = [a.astype(dtype) for a in _stage(2, B=3, N=6, ns=ns, nv=nv, R=2)[5:]]
    fac = [np.asarray(x) for x in ref[:5]]
    ref_r = jax.vmap(lambda *a: rk._resolve_xla(s0m, *a))(
        *map(jnp.asarray, fac + args[3:5] + rhs))
    out_r = trk.resolve(s0m, *(torch.as_tensor(a) for a in fac + args[3:5] + rhs))
    for x, y in zip(ref_r, out_r):
        assert _rel(x, y.numpy()) < tol


def _expv_inputs(seed, B, K, xd, nd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [0.5 * rng.normal(size=(B, xd, xd)), 0.5 * rng.normal(size=(B, nd, xd, xd)),
            0.3 * rng.normal(size=(B, K, nd)), 0.1 + 0.05 * rng.random((B, K)),
            rng.normal(size=(B, K, xd)), rng.normal(size=(B, K, xd))]
    return [a.astype(dtype) for a in arrs]


@pytest.mark.parametrize("xd,nd", [(8, 2), (3, 1), (8, 8)])
def test_generic_expv_plain_matches_jax(xd, nd):
    """Plain K3/K4 at the generic kernels' shapes: f64 against the JAX
    package's XLA versions to 1e-10; f32 to 2e-6 (the L1 form relative to
    max(Σ|r|, 1)) against its Pallas kernels in interpret mode — K4 at
    every shape, K3 at (3,1); K3 at x_dim 8 against its f32 XLA version,
    because the Pallas interpreter takes 1-10 minutes to trace K3 at
    x_dim 8 on the CPU."""
    a64 = _expv_inputs(3, 5, 7, xd, nd, np.float64)
    ref = jax.vmap(lambda *a: _window_jac_xla(12, True, *a))(*map(jnp.asarray, a64[:5]))
    np.testing.assert_allclose(tek.window_jac(12, True, *map(torch.as_tensor, a64[:5])).numpy(),
                               np.asarray(ref), atol=1e-10, rtol=0)
    ref_r = jax.vmap(lambda *a: _res_xla(12, *a))(*map(jnp.asarray, a64))
    one = [torch.as_tensor(a if i < 2 else a[:, None]) for i, a in enumerate(a64)]
    np.testing.assert_allclose(tek.residual_action(12, *one)[:, 0].numpy(), np.asarray(ref_r),
                               atol=1e-10, rtol=0)
    a32 = _expv_inputs(4, 9, 7, xd, nd, np.float32)
    j32 = list(map(jnp.asarray, a32))
    if xd < 8:
        ref = _window_jac_pallas(12, True, *j32[:5], interpret=True)
    else:
        ref = jax.vmap(lambda *a: _window_jac_xla(12, True, *a))(*j32[:5])
    np.testing.assert_allclose(tek.window_jac(12, True, *map(torch.as_tensor, a32[:5])).numpy(),
                               np.asarray(ref), atol=2e-6, rtol=0)
    ref_r = np.asarray(_res_pallas(12, *j32, interpret=True))
    one = [torch.as_tensor(a if i < 2 else a[:, None]) for i, a in enumerate(a32)]
    np.testing.assert_allclose(tek.residual_action(12, *one)[:, 0].numpy(), ref_r, atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(tek.residual_l1(12, *one)[:, 0].numpy(),
                               np.abs(ref_r).sum(axis=(-2, -1)), rtol=2e-6, atol=2e-6)


def test_new_instantiations_are_in_the_kernel_sources():
    """The size-class K1/K2 reach the caps, (24, 24, 8) being their widest
    class, chosen for the shapes past the smaller classes; the size-class
    K3/K4 reach them too, (8, 8) being their widest class, and both C
    entries dispatch every in-range pair without an exact instance to
    them."""
    src = Path(trk.__file__).parent.parent / "csrc"
    for kind, name in (("factor_solve", "factor"), ("resolve", "resolve")):
        ric = (src / f"riccati_classed_{name}.cu").read_text()
        assert re.search(rf"return launch_{kind}_classed<24, 24, 8>\(", ric)
        assert trk.size_class(kind, 17, 3, 2) == trk.size_class(kind, 3, 9, 2) == (24, 24, 8)
    assert trk.SIZE_CLASSES[-1] == (24, 24, 8)
    assert _build.RICCATI_CAPS == {"ns": 24, "nv": 24, "R": 40}
    exv = (src / "expv_kernel.cu").read_text()
    common = (src / "expv_common.cuh").read_text()
    classed = (src / "expv_classed.cu").read_text()
    assert "constexpr int kDimMax = 8;" in common and _build.EXPV_CAPS == {"xd": 8, "nd": 8}
    assert re.search(r"return launch_jac_classed\(P, T, K, order, .*Dims\{xd, nd\}", exv)
    assert re.search(r"return launch_res_classed\(l1 != 0, .*Dims\{xd, nd\}", exv)
    assert re.search(r"if \(xd <= 8 && nd <= 8\) return launch_jac_c<8, 8>\(", classed)
    assert re.search(r"if \(xd <= 8 && nd <= 8\)\s*return launch_res_l1<8, 8>\(", classed)
    assert tek.SIZE_CLASSES[-1] == (8, 8) and tek.size_class(5, 3) == (8, 8)


def test_path7e_f64_solve_matches_jax():
    """Path 7e's lanes 0-3 (the scaling family at state_dim 4, N=51, Padé;
    K1/K2 at (6,3,·)) solved by the port in float64 on the CPU at
    ``scaled_config()``'s options against the JAX package's float64 solve
    (``tests/golden/torch/scaled_dim4.npz``, ``make_scaled_dim4.py``):
    through the options' first two phases (20 + 30 iterations), equal
    iterations and converged flags, Z within 1e-8 (the bound of the
    golden's small solve, ``test_scaled_small_solve_matches_golden``).
    Lanes 2 and 3 converge there, at their whole solve's iterates (the
    golden's ``p7e_Z`` to 1e-8 too); the whole solve of lanes 0-1 runs to
    122 and 378 iterations, over which these non-convex problems amplify
    lane 0's 4.4e-9 gap after 50 iterations to 2.06."""
    gold = np.load(tb.GOLDEN_SCALED_DIM4)
    kw = dict(tb.scaled_config()["solve_kw"], chunk=4)
    kw["phases"] = kw["phases"][:2]
    prob = tb.make_batched_scaled_problems(4, 51, 4, device="cpu", dtype=torch.float64)
    res = solve_batch_compact(prob, **kw)
    assert res.iterations.tolist() == gold["p7e_short_iterations"].tolist()
    assert res.converged.tolist() == gold["p7e_short_converged"].tolist()
    Z = res.problem.trajectory.to_zvec().numpy()
    np.testing.assert_allclose(Z, gold["p7e_short_Z"], atol=1e-8, rtol=0)
    done = gold["p7e_iterations"] == gold["p7e_short_iterations"]
    assert done.tolist() == [False, False, True, True]
    np.testing.assert_allclose(Z[done], gold["p7e_Z"][done], atol=1e-8, rtol=0)
