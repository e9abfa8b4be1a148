from .base import (
    stack_hessians_zk,
    stack_jacobians_zk,
    stack_residuals,
    stack_residuals_l1,
    windows,
)
from .bilinear import BilinearIntegrator
from .derivative import DerivativeIntegrator
from .time_dependent import GeneralIntegrator, rk4_step

__all__ = [
    "BilinearIntegrator",
    "DerivativeIntegrator",
    "GeneralIntegrator",
    "stack_hessians_zk",
    "stack_jacobians_zk",
    "stack_residuals",
    "stack_residuals_l1",
    "windows",
    "rk4_step",
]
