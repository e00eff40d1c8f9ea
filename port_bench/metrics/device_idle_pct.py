"""device_idle_pct: the share of the traced window in which nothing ran
on the device (1 - the union of kernel, copy and set intervals over the
window), in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
