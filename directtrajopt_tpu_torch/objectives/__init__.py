from .base import CompositeObjective, ObjectiveBase, objective_value
from .regularizers import QuadraticRegularizer

__all__ = ["CompositeObjective", "ObjectiveBase", "QuadraticRegularizer", "objective_value"]
