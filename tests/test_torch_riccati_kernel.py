"""The port's Riccati factor+solve and resolve (plain PyTorch versions of the
CUDA kernels) against the JAX package.

f64: against the XLA scans ``_factor_solve_xla`` / ``_resolve_xla`` to 1e-12
relative (both are exact algorithms in f64; only rounding differs). f32:
against the Pallas kernels in interpret mode to 5e-6 relative, the bound
``tests/test_pallas_kkt.py`` puts on the Pallas kernel itself; the ``ok``
certificate must agree exactly, including on indefinite stages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directtrajopt_tpu.ops import riccati_kernel as rk
from directtrajopt_tpu_torch.ops import _build
from directtrajopt_tpu_torch.ops import riccati_kernel as trk

torch.set_num_threads(1)

NAMES = ["P", "Lv", "Kg", "Mvs", "L0", "ok", "dzs", "dzv", "lam"]


def _stage_data(seed, B=4, N=7, ns=5, nv=3, R=3, convex=True):
    """Random stage stacks, the generator of tests/test_pallas_kkt.py."""
    rng = np.random.default_rng(seed)

    def sym(x):
        return 0.5 * (x + np.swapaxes(x, -1, -2))

    shift = 2.0 if convex else 0.3
    Qss = sym(rng.standard_normal((B, N, ns, ns))) * 0.1 + np.eye(ns) * shift
    Qsv = rng.standard_normal((B, N, ns, nv)) * 0.1
    Qvv = sym(rng.standard_normal((B, N, nv, nv))) * 0.1 + np.eye(nv) * shift
    A = rng.standard_normal((B, N, ns, ns)) * 0.3
    A[:, -1] = 0.0
    Bm = rng.standard_normal((B, N, ns, nv)) * 0.3
    Bm[:, -1] = 0.0
    qs = rng.standard_normal((B, R, N, ns))
    qv = rng.standard_normal((B, R, N, nv))
    b = rng.standard_normal((B, R, N, ns))
    b[:, :, -1] = 0.0
    return [Qss, Qsv, Qvv, A, Bm, qs, qv, b]


def _s0m(ns):
    s0m = np.ones(ns)
    s0m[: min(2, ns - 1)] = 0.0
    return s0m


def _rel(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return np.max(np.abs(x - y)) / max(np.max(np.abs(x)), 1.0)


def _jax_xla(s0m, args):
    return jax.vmap(lambda *a: rk._factor_solve_xla(s0m, *a))(*map(jnp.asarray, args))


@pytest.mark.parametrize("ns,nv,R,N", [(8, 3, 3, 51), (5, 2, 2, 9)])
def test_factor_solve_f64_matches_xla(ns, nv, R, N):
    s0m = _s0m(ns)
    args = _stage_data(0, N=N, ns=ns, nv=nv, R=R)
    ref = _jax_xla(s0m, args)
    out = trk.factor_solve(s0m, *(torch.as_tensor(a) for a in args))
    for name, x, y in zip(NAMES, ref, out):
        if name == "ok":
            assert (np.asarray(x) == y.numpy()).all()
            continue
        assert y.shape == x.shape, name
        assert _rel(x, y.numpy()) < 1e-12, name


@pytest.mark.parametrize("ns,nv,R", [(8, 3, 3), (4, 2, 6)])
def test_factor_solve_f32_matches_pallas_interpret(ns, nv, R):
    s0m = _s0m(ns)
    args = [a.astype(np.float32) for a in _stage_data(1, B=5, ns=ns, nv=nv, R=R)]
    ref = rk._factor_solve_pallas(s0m, *map(jnp.asarray, args), interpret=True)
    out = trk.factor_solve(s0m, *(torch.as_tensor(a) for a in args))
    for name, x, y in zip(NAMES, ref, out):
        if name == "ok":
            assert (np.asarray(x) == y.numpy()).all()
            continue
        assert y.dtype == torch.float32
        assert _rel(x, y.numpy()) < 5e-6, name


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nonconvex_certificate_agrees(dtype):
    """Indefinite stages: ``ok`` equals the JAX verdict lane for lane."""
    s0m = np.ones(5)
    args = [a.astype(dtype) for a in _stage_data(2, B=8, convex=False)]
    ref = _jax_xla(s0m, args)
    out = trk.factor_solve(s0m, *(torch.as_tensor(a) for a in args))
    ok_ref = np.asarray(ref[5])
    assert (ok_ref == out[5].numpy()).all()
    assert not ok_ref.all()  # the fixture really is indefinite somewhere
    if dtype == np.float32:
        pal = rk._factor_solve_pallas(s0m, *map(jnp.asarray, args), interpret=True)
        assert (np.asarray(pal[5]) == out[5].numpy()).all()
    else:
        # identity substitution: the failing lanes' factors match too
        for name, x, y in zip(NAMES, ref, out):
            if name != "ok":
                assert _rel(x, y.numpy()) < 1e-12, name


@pytest.mark.parametrize("R", [1, 2])
def test_resolve_matches_jax(R):
    ns, nv = 8, 3
    s0m = _s0m(ns)
    args = _stage_data(3, B=3, N=11, ns=ns, nv=nv, R=R)
    fac = _jax_xla(s0m, args)
    ref = jax.vmap(lambda *a: rk._resolve_xla(s0m, *a))(*fac[:5], *map(jnp.asarray, args[3:]))
    tfac = [torch.as_tensor(np.asarray(t)) for t in fac[:5]]
    out = trk.resolve(s0m, *tfac, *(torch.as_tensor(a) for a in args[3:]))
    for name, x, y in zip(["dzs", "dzv", "lam"], ref, out):
        assert _rel(x, y.numpy()) < 1e-12, name
    # f32 against the Pallas resolve kernel in interpret mode
    fac32 = [np.asarray(t, np.float32) for t in fac[:5]]
    a32 = [a.astype(np.float32) for a in args[3:]]
    ref32 = rk._resolve_pallas(s0m, *map(jnp.asarray, fac32 + a32), interpret=True)
    out32 = trk.resolve(s0m, *(torch.as_tensor(a) for a in fac32 + a32))
    for name, x, y in zip(["dzs", "dzv", "lam"], ref32, out32):
        assert _rel(x, y.numpy()) < 5e-6, name


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers run the plain version and count no launch."""
    s0m = _s0m(5)
    args = [torch.as_tensor(a, dtype=torch.float32) for a in _stage_data(4)]
    before = dict(_build.LAUNCHES)
    out = trk.factor_solve(s0m, *args)
    ref = trk.factor_solve_plain(s0m, *args)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    assert _build.LAUNCHES == before


def test_wrapper_checks_shapes():
    s0m = _s0m(5)
    args = [torch.as_tensor(a) for a in _stage_data(5)]
    args[2] = args[2][:, :-1]  # Qvv with the wrong number of stages
    with pytest.raises(ValueError, match="Qvv"):
        trk.factor_solve(s0m, *args)
