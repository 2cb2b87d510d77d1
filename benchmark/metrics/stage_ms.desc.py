"""Mean ms of the program's own fenced ``desc_time`` span
(``register_pair_timed``) over the entry's stage requests."""


def read(run):
    return None if run.stages is None else run.stages["desc"]
