"""Device resolution: the port runs on the card unless told otherwise."""

from __future__ import annotations

import torch

import functools

__all__ = ["resolve_device", "constant"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain PyTorch versions"
        )
    return dev


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
