"""spec_used_pct: the share of the speculative extension items the
band service scored whose counts the engine's finish replay read
(100 x spec_item_used_count / spec_item_count, summed over the
genotyper's and the analyzer's stage records)."""


def read(run):
    spec = run.counter_total("spec_item_count")
    used = run.counter_total("spec_item_used_count")
    if spec is None or used is None or not spec:
        return None
    return 100.0 * used / spec
