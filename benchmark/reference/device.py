"""Small constant tensors, cached per device (frozen copy)."""

from __future__ import annotations

import functools

import torch

__all__ = ["constant"]


@functools.lru_cache(maxsize=None)
def _constant(values, shape, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device).reshape(shape)


def constant(values, dtype: torch.dtype, device, shape=None) -> torch.Tensor:
    """A small read-only tensor of ``values`` (a flat sequence of numbers) on
    ``device``, made once and kept. A host-to-device copy waits for all the
    work queued on the stream, so the serving path never builds a constant
    from host values twice: it asks here. Do not write to the result."""
    values = tuple(values)
    shape = (len(values),) if shape is None else tuple(shape)
    return _constant(values, shape, dtype, torch.device(device))
