"""train.device_idle_pct: the share of the traced window in which no
operation ran on the device (the union of the device's intervals), in %."""


def read(outcome, patterns):
    tr = outcome.trace
    if tr is None or tr.window_s <= 0 or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
