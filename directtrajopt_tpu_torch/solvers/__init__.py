from .callbacks import (
    IPMCallbacks,
    best_fidelity_tracker,
    fidelity_stop,
    stop_iteration,
    telemetry,
    wall_clock_stop,
)
from .canonical import CanonicalNLP, make_nlp
from .ipm import TELEMETRY_COLUMNS, IPMResult, IPMState, WarmStart, ipm_solve
from .options import IPMOptions
from .solve import (
    SolveResult,
    cast_problem,
    get_default_options,
    remove_slack_variables,
    set_default_options,
    solve,
    solve_batch,
    solve_batch_compact,
    solve_batch_polished,
    solve_batch_scheduled,
    solve_polished,
)

__all__ = [
    "CanonicalNLP",
    "IPMCallbacks",
    "IPMOptions",
    "IPMResult",
    "IPMState",
    "SolveResult",
    "TELEMETRY_COLUMNS",
    "WarmStart",
    "best_fidelity_tracker",
    "cast_problem",
    "fidelity_stop",
    "get_default_options",
    "ipm_solve",
    "make_nlp",
    "remove_slack_variables",
    "set_default_options",
    "solve",
    "solve_batch",
    "solve_batch_compact",
    "solve_batch_polished",
    "solve_batch_scheduled",
    "solve_polished",
    "stop_iteration",
    "telemetry",
    "wall_clock_stop",
]
