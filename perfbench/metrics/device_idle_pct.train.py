"""device_idle_pct.train: the share of the traced window in which no device
operation ran (one minus the union of their intervals over the window)."""


def read(trace, run):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
