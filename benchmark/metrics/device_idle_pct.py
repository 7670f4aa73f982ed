"""device_idle_pct: the share of the traced window in which no operation
ran on the card, 100 x (1 - union of device intervals / window)."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
