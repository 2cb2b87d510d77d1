"""Percent: the least time the chip needs for the traced calls' model
arithmetic (``benchmark/modelflops.py``: the descriptor nets, the
cost-volume heads and mutual matching at their precisions' peaks) over the
traced window's seconds."""

from benchmark.modelflops import least_seconds


def read(run):
    if run.trace is None or run.model_units is None:
        return None
    return 100.0 * least_seconds(run.statics, run.model_units,
                                 run.traced_passes) / run.trace.window_s
