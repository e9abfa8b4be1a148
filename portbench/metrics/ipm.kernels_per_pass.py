"""Device kernels a lockstep pass in the profiled call's solve stages: the
host's dispatch count."""


def read(t):
    passes = t.call["passes"]
    n = t.profile.n_kernels
    return n / passes if passes and n else None
