"""Async host input pipeline: bounded-queue prefetch over a dataset.

The port's own copy of :mod:`bufferx_tpu.data.prefetch`. The reference
feeds its GPU through torch DataLoader worker processes (its
``dataset/dataloader.py:162-170``): per-pair CPU work (PLY decode, two
``voxel_down_sample`` passes, sphericity PCA) runs concurrently with the
model. Here worker THREADS with a bounded in-order window prepare pair
``i+k`` while pair ``i`` runs on the card.

Threads (not processes) are the right tool here: the heavy per-pair work
is numpy (voxel hashing, PCA, file decode, synthetic pairs), which releases
the GIL inside every C-level kernel, and the card is driven asynchronously
by CUDA streams, so a couple of workers hide host prep at serving
throughput without the fork hazards worker processes bring to a process
that holds a CUDA context.

Two shapes:

- :func:`prefetch_indexed` — for indexable datasets (``len`` +
  ``fn(i)``): a sliding window of ``depth`` futures, yielded in order.
- :func:`prefetch_iter` — for generators whose *iteration* is the heavy
  part: one filler thread + a bounded queue.

:func:`prefetch_samples` dispatches on the input's shape.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Sequence

__all__ = ["prefetch_indexed", "prefetch_iter", "prefetch_samples"]


def prefetch_indexed(
    fn: Callable[[int], Any],
    n: int,
    num_workers: int = 2,
    depth: int = 4,
) -> Iterator[Any]:
    """Yield ``fn(0..n-1)`` in order, computing up to ``depth`` ahead."""
    if n <= 0:
        return
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        window: list = []
        nxt = 0
        try:
            while nxt < min(depth, n):
                window.append(ex.submit(fn, nxt))
                nxt += 1
            for _ in range(n):
                fut = window.pop(0)
                if nxt < n:
                    window.append(ex.submit(fn, nxt))
                    nxt += 1
                yield fut.result()
        finally:
            for f in window:
                f.cancel()


_SENTINEL = object()


def prefetch_iter(
    it: Iterable[Any],
    depth: int = 4,
) -> Iterator[Any]:
    """Drain ``it`` in a background thread through a bounded queue.

    Use when the iterable itself performs the heavy work per ``next()``
    (generator-style loaders). Exceptions raised by the source are
    re-raised at the consuming side. Abandoning the iterator (GeneratorExit
    from an exception mid-consumption or a partial iteration) STOPS the
    filler thread: every ``put`` is timeout-polled against a stop event, so
    a blocked filler cannot leak the thread, hold sample memory, or keep
    dispatching device work (``prepare_cloud`` runs inside prefetched
    generators in the eval harness) that would overlap a later run.
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        """Bounded put that aborts when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def fill():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            err.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=fill, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        # unblock a filler waiting on a full queue so it observes the stop
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def prefetch_samples(
    pairs: Iterable[Any],
    num_workers: int = 2,
    depth: int = 4,
) -> Iterator[Any]:
    """Prefetch an eval-sample source.

    Indexable datasets (``__len__`` + ``__getitem__`` — e.g.
    a list of sample dicts) fan out across worker
    threads; other iterables get a single filler thread, and so does a
    dataset whose samples draw from one shared ``rng`` (the loaders'
    ``PairDataset``): what a sample draws depends on the order of the
    draws, so its samples are made one after another, in order, and equal
    sequential ``ds[i]``. ``num_workers <= 0`` disables prefetching (returns
    the source unchanged).
    """
    if num_workers <= 0:
        return iter(pairs)
    if hasattr(pairs, "rng"):
        return prefetch_iter(iter(pairs), depth=depth)
    if isinstance(pairs, Sequence) or (
        hasattr(pairs, "__getitem__") and hasattr(pairs, "__len__")
    ):
        return prefetch_indexed(
            pairs.__getitem__, len(pairs), num_workers=num_workers,
            depth=depth,
        )
    return prefetch_iter(pairs, depth=depth)
