"""Timing utilities.

``Timer`` / ``AverageMeter`` mirror the reference's ``utils/timer.py``;
``DeviceTimer`` is its CUDA ``GPUTimer`` (``utils/gpu_timer.py:9-33``) as
host wall time between two fences: ``torch.cuda.synchronize()`` before the
start stamp (so earlier queued work is not charged to the interval) and
after the timed work. On the CPU the work is done when the call returns and
there is nothing to fence. The counterpart of
:mod:`bufferx_tpu.utils.timers`.

:func:`span` marks a stage of the program without a fence. Tracing is on
inside :func:`tracing` and whenever a ``torch.profiler`` is recording;
otherwise a span costs one flag check and records nothing. When on, a span
enters ``torch.profiler.record_function`` (so it lands in the profiler's
trace on the clock of the device's events) and takes host ``perf_counter``
stamps; a span opened with ``stream=True`` also records a CUDA event on the
current stream at each end (in a process that has initialised CUDA;
elsewhere its stream time is its host time). A closed span goes to a store
of at most :data:`SPAN_CAPACITY` records, the oldest dropped first;
:func:`spans` resolves their stream times, returns them, empties the store
and keeps the read events for the next spans. :func:`spanned` puts every
call of a function in a span.

:func:`count` adds to a named host counter, also only while tracing is on;
each read of :func:`spans` takes the counters' totals and zeroes them, and
:func:`counters` gives the totals of that read, so that a reader sees the
counts of the same calls as the spans.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch

__all__ = ["Timer", "AverageMeter", "DeviceTimer", "SPAN_CAPACITY",
           "SpanRecord", "count", "counters", "span", "spanned", "spans",
           "tracing"]

# the most closed spans the store holds between two reads of spans()
SPAN_CAPACITY = 8192


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.avg = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True):
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.avg = self.total_time / self.calls
        return self.avg if average else self.diff


class AverageMeter:
    """Running mean/std/min/max over scalar observations."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.sq_sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.sq_sum += val * val * n
        self.count += n
        self.avg = self.sum / self.count
        self.min = min(self.min, val)
        self.max = max(self.max, val)

    @property
    def var(self):
        if self.count < 2:
            return 0.0
        return max(self.sq_sum / self.count - self.avg**2, 0.0)

    @property
    def std(self):
        return self.var**0.5


class DeviceTimer:
    """Device timing by fencing.

    Usage::

        with DeviceTimer(device) as t:
            out = fn(*args)
        elapsed = t.diff

    ``device``: the device the timed work runs on; a CUDA device is
    synchronized on entry and on exit, a CPU device is not.
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.diff = 0.0
        self.total_time = 0.0
        self.calls = 0

    def _fence(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._fence()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._fence()
        self.diff = time.perf_counter() - self._start
        self.total_time += self.diff
        self.calls += 1
        return False

    @property
    def avg(self):
        return self.total_time / max(self.calls, 1)


class SpanRecord(NamedTuple):
    """One closed span, as :func:`spans` returns it."""
    name: str
    id: int
    parent: int | None    # the enclosing span's id; None for a root
    root: int             # the root's id, shared by every span of one call
    pairs: int | None     # the pairs the span works on, where it says
    host_ms: float
    # the current stream's time between the span's two ends: the device's
    # work launched inside it and its idle time while the host lags there;
    # None for a span opened without ``stream``
    stream_ms: float | None


class _Tracer:
    """The process's tracing state: how many :func:`tracing` blocks are
    open, each thread's stack of open spans, the store of closed ones, the
    CUDA event pairs that :func:`spans` has read, to be recorded again,
    and the counters since and as of its last read."""

    def __init__(self):
        self.forced = 0
        self.local = threading.local()
        self.store: collections.deque = collections.deque(
            maxlen=SPAN_CAPACITY)
        self.ids = itertools.count(1)
        self.events: list = []
        self.counts: collections.Counter = collections.Counter()
        self.read_counts: dict = {}

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_TRACER = _Tracer()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "pairs", "stream", "id", "parent", "root",
                 "_annotation", "_events", "_t0")

    def __init__(self, name: str, pairs: int | None, stream: bool):
        self.name, self.pairs, self.stream = name, pairs, stream

    def __enter__(self):
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        stack = _TRACER.stack()
        self.id = next(_TRACER.ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self._events = None
        if self.stream and torch.cuda.is_initialized():
            self._events = (_TRACER.events.pop() if _TRACER.events else
                            (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True)))
            self._events[0].record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_ms = (time.perf_counter() - self._t0) * 1e3
        if self._events is not None:
            self._events[1].record()
        self._annotation.__exit__(*exc)
        _TRACER.stack().pop()
        _TRACER.store.append((self.name, self.id, self.parent, self.root,
                              self.pairs, host_ms, self.stream,
                              self._events))
        return False


def _on() -> bool:
    return bool(_TRACER.forced or torch.autograd._profiler_enabled())


def span(name: str, pairs: int | None = None, stream: bool = False):
    """A context manager around one stage of the program, named ``name``;
    ``pairs``: the pairs the stage works on; ``stream``: also time the
    current stream between the span's ends (two CUDA events). It records
    only while tracing is on (see the module's docstring), adds no
    synchronisation and no kernel, and nests: a span opened inside another
    is its child, and shares its root."""
    if not _on():
        return _OFF
    return _Span(name, pairs, stream)


def spanned(name: str, pairs=None, stream: bool = False):
    """A decorator: every call of the function inside :func:`span`
    ``name``. ``pairs``: a number, or a function of the call's arguments
    that gives it (read only while tracing is on)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on():
                return fn(*args, **kwargs)
            n = pairs(*args, **kwargs) if callable(pairs) else pairs
            with _Span(name, n, stream):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int) -> None:
    """Add ``n`` to the host counter ``name`` while tracing is on (see the
    module's docstring); otherwise nothing."""
    if _on():
        _TRACER.counts[name] += n


def counters() -> dict:
    """{name: total} of the counters as the last :func:`spans` read them:
    what was counted between that read and the one before it."""
    return dict(_TRACER.read_counts)


@contextlib.contextmanager
def tracing():
    """Tracing on for the block, with or without a profiler."""
    _TRACER.forced += 1
    try:
        yield
    finally:
        _TRACER.forced -= 1


def spans() -> list:
    """[:class:`SpanRecord`] of the spans closed since the last read, in the
    order they closed; empties the store, and takes and zeroes the
    counters (:func:`counters`). Waits for the device to reach each
    ``stream`` span's end to read its stream time."""
    _TRACER.read_counts = dict(_TRACER.counts)
    _TRACER.counts.clear()
    out = []
    while _TRACER.store:
        name, sid, parent, root, pairs, host_ms, stream, events = \
            _TRACER.store.popleft()
        stream_ms = host_ms if stream else None
        if events is not None:
            events[1].synchronize()
            stream_ms = events[0].elapsed_time(events[1])
            if len(_TRACER.events) < SPAN_CAPACITY:
                _TRACER.events.append(events)
        out.append(SpanRecord(name, sid, parent, root, pairs, host_ms,
                              stream_ms))
    return out
