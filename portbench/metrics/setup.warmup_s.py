"""Seconds of the warm-up: one call at the cell's own shapes, every phase
of every stage capped at one pass."""


def read(t):
    return t.setup["warmup_s"]
