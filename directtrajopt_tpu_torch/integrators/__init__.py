from .base import (
    stack_hessians_zk,
    stack_jacobians_zk,
    stack_residuals,
    stack_residuals_l1,
    windows,
)
from .bilinear import BilinearIntegrator
from .derivative import DerivativeIntegrator

__all__ = [
    "BilinearIntegrator",
    "DerivativeIntegrator",
    "stack_hessians_zk",
    "stack_jacobians_zk",
    "stack_residuals",
    "stack_residuals_l1",
    "windows",
]
