"""The program's own spans in a traced run.

The program opens a span at each of its layer boundaries
(``bufferx_tpu_torch.utils.timers.span``, names ``bufferx.*``); while the
profiler records the traced calls, each span is a ``user_annotation`` in
the trace, on the clock of the device's operations, and a record in the
program's store with its device time (CUDA events at its two ends). This
module reads both:

- :func:`stage_ms`: a stage's summed stream ms over the traced pairs, from
  the store (``timers.spans()``, read once a run and kept on it);
- :func:`idle_split`: the traced window's device-idle time split by the
  innermost program span over each gap's midpoint: ``bufferx.prepare`` is
  ingest, any other program span dispatch (the host launching, slicing or
  blocked inside the program); gaps under no program span (the harness's
  draws and result read) are in neither;
- :func:`host_syncs_per_pair`: the host's synchronising runtime calls that
  start inside a program span, over the traced pairs.

Each returns None where there is nothing to read: no trace, or a program
without spans.
"""

from __future__ import annotations

from benchmark.trace import gaps, union

__all__ = ["PREFIX", "INGEST", "SYNC_CALLS", "program_spans", "stage_ms",
           "innermost", "idle_split", "host_syncs_per_pair"]

PREFIX = "bufferx."
INGEST = "bufferx.prepare"
# runtime calls after which the host has waited for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
_UNREAD = object()


def program_spans(run) -> list | None:
    """The program's span records of the traced calls, or None where the
    program keeps none. The store is read (and emptied) once; the records
    stay on ``run``."""
    got = getattr(run, "_program_spans", _UNREAD)
    if got is _UNREAD:
        try:
            from bufferx_tpu_torch.utils.timers import spans
        except ImportError:
            got = None
        else:
            got = spans()
        run._program_spans = got
    return got


def stage_ms(run, name: str) -> float | None:
    """Summed stream ms of the spans named ``name`` over the traced pairs;
    None where none ran. A span's stream ms is the time the current stream
    takes from the span's first CUDA event to its second: the device's work
    launched inside the span and the device's idle time while the host lags
    inside it. Where the host bounds a stage it reads the host's time (under
    the profiler, the profiled host's), and a gain on the device there does
    not show in it."""
    records = program_spans(run)
    if not records or not run.traced_records:
        return None
    ms = [r.stream_ms for r in records if r.name == name]
    return sum(ms) / len(run.traced_records) if ms else None


def _program_host_spans(trace) -> list:
    return [(s, s + d, n) for n, s, d in trace.host if n.startswith(PREFIX)]


def innermost(spans: list, points: list) -> list:
    """The name of the innermost of ``spans`` [(start, end, name)] that
    covers each of ``points`` (None where none does), for spans that nest
    or do not meet, as one thread's spans do."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    order = sorted(range(len(points)), key=points.__getitem__)
    out: list = [None] * len(points)
    stack: list = []
    i = 0
    for k in order:
        x = points[k]
        while i < len(spans) and spans[i][0] <= x:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def idle_split(run) -> dict | None:
    """{"ingest": %, "dispatch": %} of the traced window: device-idle time
    under ``bufferx.prepare``, and under any other program span."""
    trace = run.trace
    if trace is None or trace.window_s <= 0:
        return None
    spans = _program_host_spans(trace)
    if not spans:
        return None
    busy = union([(s, s + d) for _n, s, d, _c in trace.device], trace.window)
    holes = gaps(busy, trace.window)
    labels = innermost(spans, [0.5 * (lo + hi) for lo, hi in holes])
    out = {"ingest": 0.0, "dispatch": 0.0}
    for (lo, hi), label in zip(holes, labels):
        if label is not None:
            out["ingest" if label == INGEST else "dispatch"] += hi - lo
    window_us = trace.window_s * 1e6
    return {k: 100.0 * v / window_us for k, v in out.items()}


def _sync_call(name: str) -> bool:
    """A synchronising runtime call (CUPTI may suffix a version, _v3020)."""
    return name.split("_v", 1)[0] in SYNC_CALLS


def host_syncs_per_pair(run) -> float | None:
    """Synchronising runtime calls that start inside a program span, over
    the traced pairs."""
    trace = run.trace
    if trace is None or not run.traced_records:
        return None
    spans = _program_host_spans(trace)
    if not spans:
        return None
    starts = [s for n, s, _d in trace.host if _sync_call(n)]
    inside = sum(label is not None for label in innermost(spans, starts))
    return inside / len(run.traced_records)
