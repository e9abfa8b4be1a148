from ._build import LAUNCHES, build_info, reset_launches
from .expm import expv_taylor

__all__ = ["LAUNCHES", "build_info", "expv_taylor", "reset_launches"]
