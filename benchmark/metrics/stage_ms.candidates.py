"""Stream ms of the program's ``bufferx.candidates`` spans
(``_scale_candidates``, one a scale a pass: alignment, SPT features, the
descriptor net, matching, the SO(2) head) in the traced calls, summed, over
the traced pairs (``benchmark.spans.stage_ms`` says what that holds)."""

from benchmark.spans import stage_ms


def read(run):
    return stage_ms(run, "bufferx.candidates")
