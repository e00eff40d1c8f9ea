"""ra_dispatch_s: seconds per sample in the read-assignment span
`dispatch`: each chunk's descriptor fetch and the band service's
checks, pinning, upload and kernel launch.
The program's dispatch_seconds, summed over the genotyper's and the
analyzer's stage records; recorded only while a profiler traces."""


def read(run):
    return run.counter_mean("dispatch_seconds")
