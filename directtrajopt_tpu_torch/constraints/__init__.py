from .base import LinearCanon, LinearConstraintBase, NonlinearConstraintBase
from .linear import BoundsConstraint, EqualityConstraint

__all__ = [
    "BoundsConstraint",
    "EqualityConstraint",
    "LinearCanon",
    "LinearConstraintBase",
    "NonlinearConstraintBase",
]
