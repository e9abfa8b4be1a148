"""The port's bilinear window Jacobians and residual chains (plain PyTorch
versions of the CUDA kernels) against the JAX package.

f64: against ``_window_jac_xla`` / ``_res_xla`` to 1e-12. f32: against the
Pallas kernels in interpret mode to atol 2e-6, the bound
``tests/test_expv_kernel.py`` puts on the Pallas kernels themselves.
Includes the L1 form and batch sizes that are not multiples of anything.
"""

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
)
from directtrajopt_tpu_torch.ops import expv_kernel as tek

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
    out = tek.residual_action(6, *_t(args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12, rtol=0)
    l1 = tek.residual_l1(6, *_t(args))
    assert l1.shape == (B,)
    np.testing.assert_allclose(
        l1.numpy(), np.asarray(jnp.sum(jnp.abs(ref), axis=(-2, -1))), atol=1e-12, rtol=0
    )


@pytest.mark.parametrize("B", [7, 9 * 3])
def test_residual_f32_matches_pallas_interpret(B):
    """B = problems × trial slots, flattened (the line-search trial grid)."""
    args = _inputs(3, B, 50, 4, 2, np.float32, with_xn=True)
    ref = np.asarray(_res_pallas(6, *map(jnp.asarray, args), interpret=True))
    out = tek.residual_action(6, *_t(args))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=0)
    l1 = tek.residual_l1(6, *_t(args)).numpy()
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
    np.testing.assert_allclose(tek.residual_action(12, *_t(args)).numpy(), ref_r, atol=2e-6, rtol=0)
    np.testing.assert_allclose(tek.residual_l1(12, *_t(args)).numpy(),
                               np.abs(ref_r).sum(axis=(-2, -1)), rtol=2e-6, atol=2e-6)


def test_kernel_wrapper_rejects_uninstantiated_shapes_only_on_cuda():
    """On the CPU every shape takes the plain version; the instantiated
    kernel shapes are the benchmark's (x_dim=4, 2 drives) and the
    state-constrained family's (x_dim=2, 1 drive)."""
    args = _inputs(4, 2, 3, 5, 2, np.float32)
    assert tek.window_jac(4, True, *_t(args)).shape == (2, 3, 5, 8)
    assert tek.SUPPORTED_SHAPES == {(4, 2), (2, 1)}
