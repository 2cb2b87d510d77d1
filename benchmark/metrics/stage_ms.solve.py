"""Stream ms of the program's ``bufferx.solve`` spans (``_pool_and_solve``:
consensus, the sampling pool, RANSAC, IRLS where it runs) in the traced
calls, summed, over the traced pairs
(``benchmark.spans.stage_ms`` says what that holds)."""

from benchmark.spans import stage_ms


def read(run):
    return stage_ms(run, "bufferx.solve")
