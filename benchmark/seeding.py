"""Streams drawn from a run's ``--seed``: any whole number, 64 bits wide.

Every stream is keyed by the seed and a tag, so that the pool, the draws
and the check's sample are independent of each other and of how many of
each a run takes.
"""

from __future__ import annotations

import zlib

import numpy as np

__all__ = ["random_state", "torch_seed"]


def _words(seed: int, tag: str, index: int) -> list:
    s = int(seed) & ((1 << 64) - 1)
    return [s & 0xFFFFFFFF, s >> 32, zlib.crc32(tag.encode()), int(index)]


def random_state(seed: int, tag: str, index: int = 0) -> np.random.RandomState:
    """A numpy stream for (seed, tag, index)."""
    state = np.random.SeedSequence(_words(seed, tag, index)).generate_state(8)
    return np.random.RandomState(state)


def torch_seed(seed: int, tag: str, index: int = 0) -> int:
    """A 63-bit seed for a ``torch.Generator`` for (seed, tag, index)."""
    state = np.random.SeedSequence(_words(seed, tag, index)).generate_state(
        2, dtype=np.uint64)
    return int(state[0]) >> 1
