"""Seconds from the process's start to the first timed request: imports,
kernel build or load, snapshot, traffic pool, draws, warm-up."""


def read(run):
    return run.setup_s
