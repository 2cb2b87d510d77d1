"""Percent of the traced window in which the device idled under the program's
``bufferx.prepare`` span (host ingest and the copy to the card) as the
innermost program span over the gap's midpoint."""

from benchmark.spans import idle_split


def read(run):
    split = idle_split(run)
    return None if split is None else split["ingest"]
