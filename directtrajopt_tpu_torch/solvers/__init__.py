from .canonical import CanonicalNLP, make_nlp
from .ipm import IPMResult, IPMState, WarmStart, ipm_solve
from .options import IPMOptions
from .solve import SolveResult, cast_problem, solve, solve_batch, solve_batch_compact

__all__ = [
    "CanonicalNLP",
    "IPMOptions",
    "IPMResult",
    "IPMState",
    "SolveResult",
    "WarmStart",
    "cast_problem",
    "ipm_solve",
    "make_nlp",
    "solve",
    "solve_batch",
    "solve_batch_compact",
]
