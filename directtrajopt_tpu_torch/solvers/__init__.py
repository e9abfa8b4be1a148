from .canonical import CanonicalNLP, make_nlp
from .ipm import IPMResult, IPMState, WarmStart, ipm_solve
from .options import IPMOptions
from .solve import (
    SolveResult,
    cast_problem,
    remove_slack_variables,
    solve,
    solve_batch,
    solve_batch_compact,
)

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
    "remove_slack_variables",
    "solve",
    "solve_batch",
    "solve_batch_compact",
]
