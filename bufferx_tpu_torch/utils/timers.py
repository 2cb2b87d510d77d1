"""Timing utilities.

``Timer`` / ``AverageMeter`` mirror the reference's ``utils/timer.py``;
``DeviceTimer`` is its CUDA ``GPUTimer`` (``utils/gpu_timer.py:9-33``) as
host wall time between two fences: ``torch.cuda.synchronize()`` before the
start stamp (so earlier queued work is not charged to the interval) and
after the timed work. On the CPU the work is done when the call returns and
there is nothing to fence. The counterpart of
:mod:`bufferx_tpu.utils.timers`.
"""

from __future__ import annotations

import time

import torch

__all__ = ["Timer", "AverageMeter", "DeviceTimer"]


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
