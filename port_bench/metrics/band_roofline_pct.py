"""band_roofline_pct: the least time of the deferred items the band
service was sent in the traced window (their bytes, and 28 int32
operations a band cell at the int32 peak) over the band kernels'
device time in the trace, in %."""

from harness.probes import band_kernel


def read(run):
    n_bytes = sum(r["band_bytes"] for r in run.window)
    n_ops = sum(r["band_ops"] for r in run.window)
    return run.roofline_pct(n_bytes, n_ops, band_kernel)
