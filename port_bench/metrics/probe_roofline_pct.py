"""probe_roofline_pct: the least time of the screen's probe launches
in the traced window (their bytes at the HBM rate, or their int32
operations, whichever is longer) over the probe kernel's device time
in the trace, in %."""

from harness.probes import probe_kernel


def read(run):
    return run.roofline_pct(run.probe_bytes, run.probe_ops, probe_kernel)
