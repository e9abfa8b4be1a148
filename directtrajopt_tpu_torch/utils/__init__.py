from .mpc import mpc_step, shift_trajectory

__all__ = ["mpc_step", "shift_trajectory"]
