"""device_idle_share: the share of the traced window, in %, in which no
operation ran on the device: 1 - (the union of the profiler's device
activity intervals) / (the window)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
