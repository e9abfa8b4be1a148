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

# name -> the ROADMAP Queue 1 item that ports it
NOT_YET = {
    "GeneralIntegrator": 7, "TimeDependentBilinearIntegrator": 7, "td_integration_error": 7,
    "tune_n_steps": 7,
}

# the port's own names: the HVP carriers and the warm start the JAX package
# keeps in its submodules, and the card's problem builders
PORT_ONLY = {
    "ConstantLowRankHVP", "CustomKnotHVP", "WarmStart", "knot_hvp",
    "make_batched_bilinear_problems", "make_batched_global_problems",
    "make_batched_state_constrained_problems", "make_bilinear_problem",
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

