"""Squared distances and mutual nearest neighbours, plain float32 (frozen
copy of the program's ``kernels/neighbors.py``).

The distance matrix is the f32 expansion ``|a|^2 - 2 a.b + |b|^2`` through
``torch.matmul`` (TF32 off in the configuration's precision); callers centre
both operands on the cloud centroid first.
"""

from __future__ import annotations

import torch

__all__ = ["sqdist", "masked_sqdist", "mutual_nearest"]

BIG = 1e30


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, N] squared distances between [..., M, D] and [..., N, D]:
    ``(|a|^2 - 2 a.b) + |b|^2`` clamped at 0, updated in place on the
    product (the same roundings as the out-of-place expression; a batch's
    matrix is gigabytes)."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    d = torch.matmul(a, b.transpose(-1, -2))
    return d.mul_(-2.0).add_(a2).add_(b2.transpose(-1, -2)).clamp_min_(0.0)


def masked_sqdist(a: torch.Tensor, b: torch.Tensor, mask_a: torch.Tensor,
                  mask_b: torch.Tensor, fill: float = BIG) -> torch.Tensor:
    """:func:`sqdist` with invalid rows and columns set to ``fill``."""
    d = sqdist(a, b)
    valid = mask_a[..., :, None] & mask_b[..., None, :]
    return d.masked_fill_(~valid, fill)


def mutual_nearest(desc_a: torch.Tensor, desc_b: torch.Tensor,
                   mask_a: torch.Tensor, mask_b: torch.Tensor):
    """Fixed-size mutual 1-NN for a batch of pairs: desc_a [B, M, D], desc_b
    [B, N, D], masks [B, M] and [B, N] -> (nn_ab [B, M] int64, mutual [B, M]
    bool, nn_d2 [B, M] f32). Ties go to the lowest index, as ``argmin``
    breaks them."""
    d = masked_sqdist(desc_a, desc_b, mask_a, mask_b)
    nn_ab = torch.argmin(d, dim=-1)                            # [B, M]
    nn_ba = torch.argmin(d, dim=-2)                            # [B, N]
    back = torch.gather(nn_ba, 1, nn_ab)
    m = back == torch.arange(desc_a.shape[1], device=d.device)
    mutual = m & mask_a & torch.gather(mask_b, 1, nn_ab)
    nn_d2 = torch.gather(d, 2, nn_ab[..., None])[..., 0]
    return nn_ab, mutual, nn_d2
