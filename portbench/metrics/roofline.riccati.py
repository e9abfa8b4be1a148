"""K1 and K2 (the Riccati factor+solve and the resolve) against their
roofline: each call's least time (its bytes over the HBM bandwidth or its
float32 operations over the peak, whichever is larger) summed over the
profiled call, over the device time of the kernels that ran them, in %."""

from harness.roofline import layer_share, riccati_ops


def _ops(call):
    factor = call.fn.endswith(":factor_solve")
    first, small = (call.args[1], call.args[3]) if factor else (call.args[1], call.args[2])
    L, N, ns = first.shape[:3]
    nv = small.shape[-1]
    R = call.args[-3].shape[1]  # qs (L, R, N, ns)
    return riccati_ops(L, N, ns, nv, R, factor)


def read(t):
    return layer_share(t, _ops)
