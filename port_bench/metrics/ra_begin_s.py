"""ra_begin_s: seconds per sample in the read-assignment span
`begin`: the engine's begin passes (hit collection, chaining, the
gap-fill and speculative extension items).
The program's begin_seconds, summed over the genotyper's and the
analyzer's stage records; recorded only while a profiler traces."""


def read(run):
    return run.counter_mean("begin_seconds")
