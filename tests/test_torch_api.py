"""The port's public surface against the JAX package's.

The top-level public names of ``directtrajopt_tpu_torch`` equal those of
``directtrajopt_tpu``, less two explicit lists — the names left out on
purpose and the names not yet ported (each with the ROADMAP Queue 1 item
that ports it) — plus the port's own additions. Later slices shrink the
not-yet-ported list.
"""

import types

import directtrajopt_tpu as dtx
import directtrajopt_tpu_torch as tdx

# JAX pytree machinery, the jitted entry point and a greeting: no counterpart
LEFT_OUT = {"module", "static_field", "HashableArray", "solve_jit", "say_hello"}

# name -> the ROADMAP Queue 1 item that ports it (none are left)
NOT_YET: dict = {}

# the port's own names: the HVP carriers and the warm start the JAX package
# keeps in its submodules, and the card's problem builders
PORT_ONLY = {
    "ConstantLowRankHVP", "CustomKnotHVP", "WarmStart", "knot_hvp",
    "make_batched_bilinear_problems", "make_batched_global_problems",
    "make_batched_state_constrained_problems", "make_bilinear_problem",
    "make_batched_cartpole_problems", "make_cartpole_problem",
}


def _public(pkg):
    return {n for n in dir(pkg)
            if not n.startswith("_") and not isinstance(getattr(pkg, n), types.ModuleType)}


def test_public_names_match():
    jax_names, port_names = _public(dtx), _public(tdx)
    assert not (LEFT_OUT | set(NOT_YET)) & port_names
    assert (LEFT_OUT | set(NOT_YET)) <= jax_names
    assert jax_names - LEFT_OUT - set(NOT_YET) == port_names - PORT_ONLY
    assert set(tdx.__all__) == port_names



def test_integrators_module_names():
    """``rk4_step`` is exported from ``integrators`` only, as in the JAX
    package; ``GeneralIntegrator`` from both."""
    from directtrajopt_tpu import integrators as ji
    from directtrajopt_tpu_torch import integrators as ti

    assert "rk4_step" not in _public(dtx) and "rk4_step" not in _public(tdx)
    assert {"rk4_step", "GeneralIntegrator"} <= set(ji.__all__) & set(ti.__all__)
    assert tdx.GeneralIntegrator is ti.GeneralIntegrator


def test_check_supported_refuses_only_floor_and_dense_lbfgs():
    """The port refuses no option value of the JAX package's on either
    backend: "floor" and L-BFGS on the dense backend, which this test once
    listed as refused, are ported. Only an unknown regularization raises."""
    import pytest

    refused = set()
    values = {"mu_strategy": ("monotone", "mehrotra", "adaptive"),
              "hessian_approximation": ("exact", "gauss_newton", "lbfgs"),
              "hessian_regularization": ("auto", "inertia", "stagewise", "project", "flip",
                                         "floor"),
              "dual_init": ("zero", "least_squares"), "refine_residuals": (False, True),
              "ls_memory": (1, 4)}
    for name, vals in values.items():
        for v in vals:
            for backend in ("riccati", "dense"):
                opts = tdx.IPMOptions(**{name: v})
                if (name, v, backend) in refused:
                    with pytest.raises(NotImplementedError, match="ROADMAP"):
                        opts.check_supported(backend)
                else:
                    opts.check_supported(backend)
    for backend in ("riccati", "dense"):
        with pytest.raises(ValueError, match="unknown hessian_regularization"):
            tdx.IPMOptions(hessian_regularization="clip").check_supported(backend)
