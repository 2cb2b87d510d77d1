"""Farthest point sampling, plain PyTorch (frozen copy of the port's K1
plain version).

A batch of clouds ``xyz [B, N, 3]`` with validity ``mask [B, N]``: padded
slots start the running min-distance field at -1 (they never win the
argmax), valid ones at +inf (the first pick is the first valid index), and
each round takes the argmax with ties to the lowest index. The squared
distance is ``(dx*dx + dy*dy) + dz*dz`` in that order. :func:`fps`
finalizes: indices past the number of valid points repeat the first pick,
and ``valid_out`` marks the real ones.
"""

from __future__ import annotations

import torch

__all__ = ["farthest_point_sampling", "fps"]


def _sqdist3(diff: torch.Tensor) -> torch.Tensor:
    """(dx*dx + dy*dy) + dz*dz over the last axis, each op rounded alone."""
    dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def farthest_point_sampling(xyz: torch.Tensor, mask: torch.Tensor,
                            num_samples: int) -> torch.Tensor:
    """Raw FPS indices [B, num_samples] int32 (before finalizing)."""
    b = xyz.shape[0]
    mind = torch.where(
        mask, torch.full_like(xyz[..., 0], float("inf")),
        torch.full_like(xyz[..., 0], -1.0),
    )
    rows = torch.arange(b, device=xyz.device)
    out = torch.empty((b, num_samples), dtype=torch.int32, device=xyz.device)
    for i in range(num_samples):
        sel = torch.argmax(mind, dim=1)                       # [B]
        out[:, i] = sel.to(torch.int32)
        d = _sqdist3(xyz - xyz[rows, sel][:, None, :])
        mind = torch.minimum(mind, d)
    return out


def fps(xyz: torch.Tensor, mask: torch.Tensor, num_samples: int):
    """Masked FPS for a batch: returns (idx [B, K] int64, valid_out [B, K])."""
    if xyz.ndim != 3 or xyz.shape[-1] != 3 or mask.shape != xyz.shape[:2]:
        raise ValueError(f"fps expects xyz [B, N, 3] and mask [B, N], got "
                         f"{tuple(xyz.shape)} and {tuple(mask.shape)}")
    idx = farthest_point_sampling(xyz, mask, num_samples)
    idx = idx.long()
    num_valid = mask.sum(dim=1, keepdim=True)
    valid_out = torch.arange(num_samples, device=xyz.device)[None] < num_valid
    idx = torch.where(valid_out, idx, idx[:, :1])
    return idx, valid_out
