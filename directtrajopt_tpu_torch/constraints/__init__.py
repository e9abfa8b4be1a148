from .base import LinearCanon, LinearConstraintBase, NonlinearConstraintBase
from .linear import (
    AllEqualConstraint,
    BoundsConstraint,
    DurationConstraint,
    EqualityConstraint,
    L1SlackConstraint,
    SymmetricControlConstraint,
    SymmetryConstraint,
    TimeConsistencyConstraint,
    TimeStepsAllEqualConstraint,
    TotalConstraint,
)
from .nonlinear import NonlinearKnotPointConstraint

__all__ = [
    "AllEqualConstraint",
    "BoundsConstraint",
    "DurationConstraint",
    "EqualityConstraint",
    "L1SlackConstraint",
    "LinearCanon",
    "LinearConstraintBase",
    "NonlinearConstraintBase",
    "NonlinearKnotPointConstraint",
    "SymmetricControlConstraint",
    "SymmetryConstraint",
    "TimeConsistencyConstraint",
    "TimeStepsAllEqualConstraint",
    "TotalConstraint",
]
