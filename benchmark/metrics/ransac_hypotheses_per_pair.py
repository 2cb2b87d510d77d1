"""RANSAC hypotheses scored in the traced calls, over the traced pairs: the
program's host counter ``ransac.hypotheses`` (B x H a solve, from shapes),
which counts while tracing is on and is read with the spans
(``bufferx_tpu_torch.utils.timers.counters``). A pass's solve scores a
batch's budget, so with two-phase serving it reads the budget times (1 +
the redone share). None from a program without the counter."""

from benchmark.spans import program_spans

COUNTER = "ransac.hypotheses"


def read(run):
    if program_spans(run) is None or not run.traced_records:
        return None
    try:
        from bufferx_tpu_torch.utils.timers import counters
    except ImportError:
        return None
    total = counters().get(COUNTER)
    return None if total is None else total / len(run.traced_records)
