from .base import CompositeObjective, ObjectiveBase, objective_value
from .knot_hvp import ConstantLowRankHVP, CustomKnotHVP, knot_hvp_of
from .knot_point import KnotPointObjective, TerminalObjective, knot_hvp
from .minimum_time import MinimumTimeObjective
from .regularizers import LinearRegularizer, QuadraticRegularizer

__all__ = [
    "CompositeObjective",
    "ConstantLowRankHVP",
    "CustomKnotHVP",
    "KnotPointObjective",
    "LinearRegularizer",
    "MinimumTimeObjective",
    "ObjectiveBase",
    "QuadraticRegularizer",
    "TerminalObjective",
    "knot_hvp",
    "knot_hvp_of",
    "objective_value",
]
