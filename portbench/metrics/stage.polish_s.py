"""Wall seconds of the polish stage (the second ``solve_batch_compact``
call, exact Hessian) of the profiled call, by the benchmark's span around
it; nothing where the configuration has no polish stage."""


def read(t):
    span = t.call["spans"].get("polish")
    return None if span is None else span["seconds"]
