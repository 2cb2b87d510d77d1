"""Percent of the traced calls' ``register_pair`` calls that a replay of
their recorded chain served: the program's host counters
``register.replays`` and ``register.eager`` (each call of ``register_pair``
counts one of them while tracing is on), read with the spans
(``bufferx_tpu_torch.utils.timers.counters``). None from a program without
the counters, or where no traced call went through ``register_pair``."""

from benchmark.spans import program_spans

REPLAYS = "register.replays"
EAGER = "register.eager"


def read(run):
    if program_spans(run) is None or not run.traced_records:
        return None
    try:
        from bufferx_tpu_torch.utils.timers import counters
    except ImportError:
        return None
    got = counters()
    replays, eager = got.get(REPLAYS, 0), got.get(EAGER, 0)
    if replays + eager == 0:
        return None
    return 100.0 * replays / (replays + eager)
