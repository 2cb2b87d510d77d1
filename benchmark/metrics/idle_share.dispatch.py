"""Percent of the traced window in which the device idled under any other
program span as the innermost over the gap's midpoint: the host launching,
slicing or blocked inside the program."""

from benchmark.spans import idle_split


def read(run):
    split = idle_split(run)
    return None if split is None else split["dispatch"]
