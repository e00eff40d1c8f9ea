"""read_assignment_s: seconds per sample of the program's
read_assignment stage record (the host engine with the band service)."""


def read(run):
    return run.stage_mean("read_assignment")
