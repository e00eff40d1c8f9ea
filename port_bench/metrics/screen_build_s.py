"""screen_build_s: seconds per sample in ops/phase_a.py
DeviceScreen.build (the harness span): the k-mer table built and
uploaded for each run."""


def read(run):
    return run.span_mean("screen_build")
