"""analyze_s: seconds per sample in core/analyzer.py run_analyzer (the
harness span): re-assignment, EM and variant calling."""


def read(run):
    return run.span_mean("analyze")
