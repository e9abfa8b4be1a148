"""directtrajopt_tpu_torch — the PyTorch / CUDA port of directtrajopt_tpu.

Batched interior-point direct collocation for an NVIDIA H100: the same
public surface as the JAX package, every tensor carrying a leading lane
(scenario) axis, and hand-written Hopper kernels in place of the JAX
package's Pallas kernels (``csrc/``). The JAX package stays the reference
the port is tested against.
"""

from .benchmarks import (
    make_batched_bilinear_problems,
    make_batched_state_constrained_problems,
    make_bilinear_problem,
)
from .constraints import (
    AllEqualConstraint,
    BoundsConstraint,
    DurationConstraint,
    EqualityConstraint,
    L1SlackConstraint,
    NonlinearKnotPointConstraint,
    SymmetricControlConstraint,
    SymmetryConstraint,
    TimeConsistencyConstraint,
    TimeStepsAllEqualConstraint,
    TotalConstraint,
)
from .integrators import BilinearIntegrator, DerivativeIntegrator
from .objectives import (
    CompositeObjective,
    ConstantLowRankHVP,
    CustomKnotHVP,
    KnotPointObjective,
    LinearRegularizer,
    MinimumTimeObjective,
    QuadraticRegularizer,
    TerminalObjective,
    knot_hvp,
)
from .problem import DirectTrajOptProblem, get_trajectory_constraints
from .rollout import bilinear_rollout, rollout, rollout_fidelity
from .solvers import (
    IPMOptions,
    SolveResult,
    WarmStart,
    cast_problem,
    remove_slack_variables,
    solve,
    solve_batch,
    solve_batch_compact,
)
from .trajectory import Layout, Trajectory

__all__ = [
    "AllEqualConstraint",
    "BilinearIntegrator",
    "BoundsConstraint",
    "CompositeObjective",
    "ConstantLowRankHVP",
    "CustomKnotHVP",
    "DerivativeIntegrator",
    "DirectTrajOptProblem",
    "DurationConstraint",
    "EqualityConstraint",
    "IPMOptions",
    "KnotPointObjective",
    "L1SlackConstraint",
    "Layout",
    "LinearRegularizer",
    "MinimumTimeObjective",
    "NonlinearKnotPointConstraint",
    "QuadraticRegularizer",
    "SolveResult",
    "SymmetricControlConstraint",
    "SymmetryConstraint",
    "TerminalObjective",
    "TimeConsistencyConstraint",
    "TimeStepsAllEqualConstraint",
    "TotalConstraint",
    "Trajectory",
    "WarmStart",
    "bilinear_rollout",
    "cast_problem",
    "get_trajectory_constraints",
    "knot_hvp",
    "make_batched_bilinear_problems",
    "make_batched_state_constrained_problems",
    "make_bilinear_problem",
    "remove_slack_variables",
    "rollout",
    "rollout_fidelity",
    "solve",
    "solve_batch",
    "solve_batch_compact",
]
