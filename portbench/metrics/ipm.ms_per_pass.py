"""Milliseconds a lockstep pass: the wall seconds of the profiled call's
solve stages (the benchmark's spans around each ``solve_batch_compact``,
each ending once the device has finished) over its passes. Read in the
traced run, so the profiler's own cost is in it (PERF.md)."""


def read(t):
    passes = t.call["passes"]
    seconds = sum(s["seconds"] for s in t.call["spans"].values())
    return 1e3 * seconds / passes if passes and seconds > 0 else None
