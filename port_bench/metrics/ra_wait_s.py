"""ra_wait_s: seconds per sample in the read-assignment span
`wait`: the host blocked on the band service's counts.
The program's wait_seconds, summed over the genotyper's and the
analyzer's stage records; recorded only while a profiler traces."""


def read(run):
    return run.counter_mean("wait_seconds")
