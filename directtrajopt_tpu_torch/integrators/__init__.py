from .base import (
    evaluate,
    integrator_dim,
    stack_hessians,
    stack_hessians_zk,
    stack_jacobians,
    stack_jacobians_zk,
    stack_residuals,
    stack_residuals_l1,
    windows,
)
from .bilinear import BilinearIntegrator
from .derivative import DerivativeIntegrator
from .time_dependent import (
    GeneralIntegrator,
    TimeDependentBilinearIntegrator,
    rk4_step,
    td_integration_error,
    tune_n_steps,
)

__all__ = [
    "BilinearIntegrator",
    "DerivativeIntegrator",
    "GeneralIntegrator",
    "TimeDependentBilinearIntegrator",
    "evaluate",
    "integrator_dim",
    "stack_hessians",
    "stack_hessians_zk",
    "stack_jacobians",
    "stack_jacobians_zk",
    "stack_residuals",
    "stack_residuals_l1",
    "windows",
    "rk4_step",
    "td_integration_error",
    "tune_n_steps",
]
