"""Stream ms of the program's ``bufferx.prefilter`` spans (the clutter
prefilter, ``density_inlier_mask``, inside precompute) in the traced calls,
summed, over the traced pairs
(``benchmark.spans.stage_ms`` says what that holds)."""

from benchmark.spans import stage_ms


def read(run):
    return stage_ms(run, "bufferx.prefilter")
