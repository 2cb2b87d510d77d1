"""Stream ms of the program's ``bufferx.ransac`` spans (the RANSAC solve,
``ransac_pose``, inside solve) in the traced calls, summed, over the traced
pairs (``benchmark.spans.stage_ms`` says what that holds). None from a
program without the span."""

from benchmark.spans import stage_ms


def read(run):
    return stage_ms(run, "bufferx.ransac")
