"""K3 and K4 (the window Jacobian and the residual chain of the Taylor
bilinear integrator) against their roofline, as ``roofline.riccati``."""

from harness.roofline import horner_ops, layer_share


def _ops(call):
    fn = call.fn.split(":")[1]
    order, Gv = call.args[0], call.args[3 if fn == "window_jac" else 2]
    nd = Gv.shape[1]
    if fn == "window_jac":  # (order, free_time, Gd, Gv, u, dt, x), x (L, K, xd)
        L, K, xd = call.args[6].shape
        return horner_ops(L, K, xd, nd, order, True, bool(call.args[1]))
    P, T, K, xd = call.args[5].shape  # x (P, T, K, xd)
    if fn == "window_jac_zk":  # (order, Gd, Gv, u, dt, x, cols, d)
        return horner_ops(P * T, K, xd, nd, order, True, call.args[6][2] is not None)
    return horner_ops(P * T, K, xd, nd, order, False)


def read(t):
    return layer_share(t, _ops)
