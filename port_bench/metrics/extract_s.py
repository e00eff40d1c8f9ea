"""extract_s: seconds per sample in core/extractor.py run_extractor
(the harness span): ingest, encoding, the screen and its set-up."""


def read(run):
    return run.span_mean("extract")
