"""em_s: seconds per sample of the program's em_quantification stage
record."""


def read(run):
    return run.stage_mean("em_quantification")
