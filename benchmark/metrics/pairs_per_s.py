"""Pairs whose pose reached the host in the window, over the window's
seconds (from its start to the return of the last call begun in it)."""


def read(run):
    return len(run.records) / run.window_s if run.window_s > 0 else None
