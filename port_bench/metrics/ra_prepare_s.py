"""ra_prepare_s: seconds per sample in the read-assignment span
`prepare`: the grouping of identical reads, their encoding, and the
band service's reference check, read layout and read upload.
The program's prepare_seconds, summed over the genotyper's and the
analyzer's stage records; recorded only while a profiler traces."""


def read(run):
    return run.counter_mean("prepare_seconds")
