"""Share of the profiled call's solve stages, on the device, in which no
kernel, copy or set ran (the union of their intervals), in %."""


def read(t):
    w = t.profile.window_s
    return 100.0 * (1.0 - t.profile.busy_s / w) if w > 0 and t.profile.events else None
