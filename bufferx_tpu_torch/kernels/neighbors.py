"""Squared distances and mutual nearest neighbours (plain float32).

Counterpart of :mod:`bufferx_tpu.kernels.neighbors` for the ported path.
The distance matrix is the plain f32 expansion ``|a|^2 - 2 a.b + |b|^2``
through ``torch.matmul`` with TF32 off; the TPU's bf16 hi/lo compensated
product (``sqdist_compensated``) is not copied. Callers centre both operands
on the cloud centroid first, which keeps the cancellation error small.
"""

from __future__ import annotations

import torch

__all__ = ["sqdist", "masked_sqdist", "mutual_nearest"]

BIG = 1e30


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, N] squared distances between [..., M, D] and [..., N, D]."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    ab = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp_min(a2 - 2.0 * ab + b2.transpose(-1, -2), 0.0)


def masked_sqdist(a: torch.Tensor, b: torch.Tensor, mask_a: torch.Tensor,
                  mask_b: torch.Tensor, fill: float = BIG) -> torch.Tensor:
    """:func:`sqdist` with invalid rows and columns set to ``fill``."""
    d = sqdist(a, b)
    valid = mask_a[..., :, None] & mask_b[..., None, :]
    return torch.where(valid, d, torch.full_like(d, fill))


def mutual_nearest(desc_a: torch.Tensor, desc_b: torch.Tensor,
                   mask_a: torch.Tensor, mask_b: torch.Tensor):
    """Fixed-size mutual 1-NN: (nn_ab [M] int64, mutual [M] bool,
    nn_d2 [M] f32). Ties go to the lowest index, as ``argmin`` breaks them."""
    d = masked_sqdist(desc_a, desc_b, mask_a, mask_b)
    nn_ab = torch.argmin(d, dim=-1)                            # [M]
    nn_ba = torch.argmin(d, dim=-2)                            # [N]
    m = nn_ba[nn_ab] == torch.arange(desc_a.shape[0], device=d.device)
    mutual = m & mask_a & mask_b[nn_ab]
    nn_d2 = torch.gather(d, 1, nn_ab[:, None])[:, 0]
    return nn_ab, mutual, nn_d2
