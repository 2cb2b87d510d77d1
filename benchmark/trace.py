"""Reading a ``torch.profiler`` trace of a run's traced window.

The profiler's Chrome trace is exported to a file under the run's scratch
directory and read back here:

- device operations: events of the categories ``kernel``, ``gpu_memcpy``
  and ``gpu_memset``, with their start and length;
- host spans: ``cpu_op``, ``cuda_runtime`` and ``user_annotation`` events
  (the harness's own ``bench.*`` spans among them).

The busy time is the length of the union of the device operations'
intervals; the traced window runs from the start of the harness's first
``bench.window`` span (one a traced call) to the end of its last. Idle gaps are the holes in the union
inside the window; the longest are labelled by the innermost host span
that covers their middle (``host: no span`` when none does).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import NamedTuple

__all__ = ["DEVICE_CATEGORIES", "Trace", "read_chrome_trace", "union",
           "gaps"]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW_SPAN = "bench.window"


class Trace(NamedTuple):
    window: tuple          # (start_us, end_us)
    device: list           # [(name, start_us, dur_us, category)]
    host: list             # [(name, start_us, dur_us)]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def kernels(self) -> list:
        """[(name, start_us, dur_us)] of the kernel launches alone."""
        return [(n, s, d) for n, s, d, c in self.device if c == "kernel"]

    def busy_s(self) -> float:
        return sum(e - s for s, e in union(
            [(s, s + d) for _n, s, d, _c in self.device], self.window)) * 1e-6

    def device_by_name(self) -> dict:
        out: dict = defaultdict(float)
        for n, _s, d, _c in self.device:
            out[n] += d * 1e-6
        return dict(out)

    def idle_gaps(self, top: int = 10) -> list:
        """[(label, seconds)] of the ``top`` longest holes in the device's
        busy union inside the window, longest first."""
        busy = union([(s, s + d) for _n, s, d, _c in self.device],
                     self.window)
        holes = sorted(gaps(busy, self.window), key=lambda g: g[0] - g[1])
        out = []
        for lo, hi in holes[:top]:
            mid = 0.5 * (lo + hi)
            best = None
            for name, s, d in self.host:
                if name != WINDOW_SPAN and s <= mid <= s + d and (best is None or d < best[1]):
                    best = (name, d)
            out.append((best[0] if best else "host: no span",
                        (hi - lo) * 1e-6))
        return out


def union(intervals: list, window: tuple) -> list:
    """Sorted disjoint [(start, end)] covering ``intervals`` clipped to
    ``window``."""
    lo_w, hi_w = window
    out: list = []
    for s, e in sorted(intervals):
        s, e = max(s, lo_w), min(e, hi_w)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def gaps(busy: list, window: tuple) -> list:
    """The holes [(start, end)] of a sorted disjoint ``busy`` in ``window``."""
    out, cur = [], window[0]
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if window[1] > cur:
        out.append((cur, window[1]))
    return out


def read_chrome_trace(path: str) -> Trace | None:
    """The traced window of an exported Chrome trace; None when the trace
    holds no ``bench.window`` span or no device operation."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    window = None
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            device.append((ev.get("name", "?"), s, d, cat))
        elif cat in HOST_CATEGORIES:
            if ev.get("name") == WINDOW_SPAN:
                window = ((s, s + d) if window is None else
                          (min(window[0], s), max(window[1], s + d)))
            host.append((ev.get("name", "?"), s, d))
    if window is None or not device:
        return None
    lo, hi = window
    device = [e for e in device if e[1] + e[2] > lo and e[1] < hi]
    return Trace(window, device, host)
