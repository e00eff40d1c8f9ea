"""hits_per_read: k-mer hits the host engine collects per read it is
handed (the program's hit_count over engine_read_count, summed over the
genotyper's and the analyzer's stage records): the work that seeds
chaining and every deferred item after it."""


def read(run):
    hits = run.counter_total("hit_count")
    reads = run.counter_total("engine_read_count")
    if hits is None or not reads:
        return None
    return hits / reads
