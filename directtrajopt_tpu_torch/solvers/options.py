"""Solver options.

Counterpart of ``directtrajopt_tpu/solvers/options.py``: the same field
names and defaults (see that file for the rationale of each knob). Values
of an option that would take a code path the port does not have yet raise
``NotImplementedError`` in :meth:`IPMOptions.check_supported`, naming the
ROADMAP item that will port it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..module import module

__all__ = ["IPMOptions"]


@module
class IPMOptions:
    tol: float = 1e-8
    constr_viol_tol: float = 1e-6
    dual_inf_tol: float = 1.0
    compl_inf_tol: float = 1e-4
    acceptable_tol: float = 1e-6
    acceptable_iter: int = 15
    acceptable_constr_viol_tol: float = 1e-2
    acceptable_dual_inf_tol: float = 1e10
    acceptable_compl_inf_tol: float = 1e-2
    acceptable_obj_change_tol: float = 1e20
    diverging_iterates_tol: float = 1e20
    mu_strategy: str = "monotone"
    mu_init: float = 1e-1
    mu_min: float = 1e-12
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    kappa_epsilon: float = 10.0
    kappa_epsilon_far: float = 0.0
    kappa_mu_far: float = 0.0
    mu_switch_factor: float = 0.0
    tau_min: float = 0.99
    kappa_sigma: float = 1e10
    dual_init: str = "zero"
    lam_init_max: float = 1e3
    hessian_approximation: str = "exact"
    limited_memory_max_history: int = 6
    hessian_regularization: str = "auto"
    refine_residuals: bool = False
    compensated_residuals: bool = False
    bound_push: float = 1e-2
    bound_frac: float = 1e-2
    slack_min: float = 1e-8
    eta_ls: float = 1e-4
    theta_growth_cap: float = 0.0
    max_ls: int = 10
    max_soc: int = 1
    ls_memory: int = 1
    rest_theta_factor: float = 0.05
    rest_stall_kappa: float = 0.95
    inf_du_tol: float = 1e-4
    infeasibility_iter: int = 5
    n_rest_trials: int = 3
    delta_w_init: float = 1e-8
    delta_w_max: float = 1e10
    delta_w_factor: float = 8.0
    delta_w_decay: float = 3.0
    delta_c: float = 1e-8
    delta_w_min: float = 0.0
    delta_w_mu_scale: float = 0.3
    osc_watchdog_iter: int = 8
    osc_boost_factor: float = 10.0
    osc_small_frac: float = 0.25
    osc_boost_cap: float = 1e6
    border_penalty: float = 100.0
    max_iter: int = 1000
    max_wall_time: float = 0.0
    print_level: int = 0

    def astype(self, dtype: torch.dtype) -> "IPMOptions":
        """Round the floating-point knobs to the solve dtype (the JAX
        package casts them to arrays of that dtype). They stay Python
        floats, which PyTorch applies in the tensor's own dtype."""
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        changes = {
            f.name: float(np_dtype(getattr(self, f.name)))
            for f in dataclasses.fields(self)
            if type(getattr(self, f.name)) is float
        }
        return self.replace(**changes)

    def check_supported(self) -> None:
        """Raise on option values whose code path is not ported yet."""

        def no(option, value, item):
            raise NotImplementedError(
                f"{option}={value!r} is not ported to the PyTorch solver yet (ROADMAP {item})"
            )

        if self.mu_strategy != "monotone":
            no("mu_strategy", self.mu_strategy, "Queue 1 item 6 follow-up")
        if self.hessian_approximation not in ("exact", "gauss_newton"):
            no("hessian_approximation", self.hessian_approximation, "Queue 1 item 13")
        if self.hessian_regularization not in ("inertia", "auto"):
            no("hessian_regularization", self.hessian_regularization, "Queue 1 item 8")
        if self.refine_residuals:
            no("refine_residuals", True, "Queue 1 item 6 follow-up")
        if self.ls_memory > 1:
            no("ls_memory", self.ls_memory, "Queue 1 item 6 follow-up")
        if self.dual_init != "zero":
            no("dual_init", self.dual_init, "Queue 1 item 6 follow-up")
        if self.max_wall_time > 0.0:
            no("max_wall_time", self.max_wall_time, "Queue 1 item 14")
        if self.print_level > 0:
            no("print_level", self.print_level, "Queue 1 item 14")
