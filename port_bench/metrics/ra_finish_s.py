"""ra_finish_s: seconds per sample in the read-assignment span
`finish`: the engine's finish passes (count fold, extension
replay, full-span walks) and the copy of their results into the
caller's records.
The program's finish_seconds, summed over the genotyper's and the
analyzer's stage records; recorded only while a profiler traces."""


def read(run):
    return run.counter_mean("finish_seconds")
