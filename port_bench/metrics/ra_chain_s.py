"""ra_chain_s: the host engine's thread-seconds per sample in clustering
and chaining the hits, the largest part of the read-assignment span
`begin`.
The program's chain_seconds, summed over the genotyper's and the
analyzer's stage records; recorded only while a profiler traces."""


def read(run):
    return run.counter_mean("chain_seconds")
