"""deferred_items: deferred DP items per sample, the program's
deferred_item_count summed over the genotyper's and the analyzer's
stage records: a count of the band service's work."""


def read(run):
    return run.counter_mean("deferred_item_count")
