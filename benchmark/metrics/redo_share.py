"""Percent of the window's pairs that two-phase serving sent through every
scale (``scales_used`` > 1)."""


def read(run):
    if not run.records:
        return None
    return 100.0 * sum(r.scales_used > 1 for r in run.records) \
        / len(run.records)
