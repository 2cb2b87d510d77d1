"""Stream ms of the program's ``bufferx.describe`` spans (the descriptor net
inside each scale's candidates) in the traced calls, summed, over the traced
pairs (``benchmark.spans.stage_ms`` says what that holds)."""

from benchmark.spans import stage_ms


def read(run):
    return stage_ms(run, "bufferx.describe")
