"""Lockstep IPM passes of the profiled call: the sum over its stages of the
largest per-lane iteration count (``solve_batch_compact`` adds a lane's
iterations over the phases that ran it, and the lane that runs to the last
phase ran every pass of every phase)."""


def read(t):
    return float(t.call["passes"])
