"""screen_decided_pct: the share of the reads handed to the device
screen that it decided, from the extraction_screen stage records
(device_decided_reads over device_screened_reads); the rest go back to
the host engine."""


def read(run):
    screened = run.counter_total("device_screened_reads",
                                 "extraction_screen")
    decided = run.counter_total("device_decided_reads", "extraction_screen")
    if not screened:
        return None
    return 100.0 * decided / screened
