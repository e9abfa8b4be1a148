"""directtrajopt_tpu_torch — the PyTorch / CUDA port of directtrajopt_tpu.

Batched interior-point direct collocation for an NVIDIA H100: the same
public surface as the JAX package, every tensor carrying a leading lane
(scenario) axis, and hand-written Hopper kernels in place of the JAX
package's Pallas kernels (``csrc/``). The JAX package stays the reference
the port is tested against.
"""

from .benchmarks import make_batched_bilinear_problems, make_bilinear_problem
from .constraints import BoundsConstraint, EqualityConstraint
from .integrators import BilinearIntegrator, DerivativeIntegrator
from .objectives import CompositeObjective, QuadraticRegularizer
from .problem import DirectTrajOptProblem, get_trajectory_constraints
from .solvers import (
    IPMOptions,
    SolveResult,
    WarmStart,
    cast_problem,
    solve,
    solve_batch,
    solve_batch_compact,
)
from .trajectory import Layout, Trajectory

__all__ = [
    "BilinearIntegrator",
    "BoundsConstraint",
    "CompositeObjective",
    "DerivativeIntegrator",
    "DirectTrajOptProblem",
    "EqualityConstraint",
    "IPMOptions",
    "Layout",
    "QuadraticRegularizer",
    "SolveResult",
    "Trajectory",
    "WarmStart",
    "cast_problem",
    "get_trajectory_constraints",
    "make_batched_bilinear_problems",
    "make_bilinear_problem",
    "solve",
    "solve_batch",
    "solve_batch_compact",
]
