"""device: the share of the profiled window in which no operation ran on the
device: one minus the union of the device intervals over the window's wall
time, both inside the one profiled window."""


def read(ctx):
    prof = ctx["profile"]
    if prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
