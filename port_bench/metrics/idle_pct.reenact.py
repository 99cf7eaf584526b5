"""The device's idle share of the traced window: 100 × (1 − the union of
its kernel and memory intervals over the window)."""


def read(run):
    tr = run.readings["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
