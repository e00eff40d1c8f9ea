"""ra_fullspan_s: the host engine's thread-seconds per sample in its
near-best full-span walks and coverage scatter, the largest part of the
read-assignment span `finish`.
The program's fullspan_seconds, summed over the genotyper's and the
analyzer's stage records; recorded only while a profiler traces."""


def read(run):
    return run.counter_mean("fullspan_seconds")
