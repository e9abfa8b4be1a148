from .mpc import mpc_step, shift_trajectory
from .profiling import time_structure_build, trace

__all__ = ["mpc_step", "shift_trajectory", "trace", "time_structure_build"]
