from .base import (
    CompositeObjective,
    NullObjective,
    ObjectiveBase,
    objective_gradient,
    objective_value,
)
from .global_objectives import GlobalKnotPointObjective, GlobalObjective, GlobalTerminalObjective
from .knot_hvp import ConstantLowRankHVP, CustomKnotHVP, knot_hvp_of
from .knot_point import KnotPointObjective, TerminalObjective, knot_hvp
from .minimum_time import MinimumTimeObjective
from .regularizers import LinearRegularizer, QuadraticRegularizer

__all__ = [
    "CompositeObjective",
    "ConstantLowRankHVP",
    "CustomKnotHVP",
    "GlobalKnotPointObjective",
    "GlobalObjective",
    "GlobalTerminalObjective",
    "KnotPointObjective",
    "LinearRegularizer",
    "MinimumTimeObjective",
    "NullObjective",
    "ObjectiveBase",
    "QuadraticRegularizer",
    "TerminalObjective",
    "knot_hvp",
    "knot_hvp_of",
    "objective_gradient",
    "objective_value",
]
