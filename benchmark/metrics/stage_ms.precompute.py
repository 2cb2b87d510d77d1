"""Stream ms of the program's ``bufferx.precompute`` spans (``_precompute``:
the prefilter, FPS, the distance matrices, the radii, the stratified query)
in the traced calls, summed, over the traced pairs
(``benchmark.spans.stage_ms`` says what that holds)."""

from benchmark.spans import stage_ms


def read(run):
    return stage_ms(run, "bufferx.precompute")
