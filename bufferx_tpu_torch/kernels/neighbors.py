"""Squared distances, nearest neighbours and the flat ball query (plain
float32).

Counterpart of :mod:`bufferx_tpu.kernels.neighbors` for the ported path.
The distance matrix is the plain f32 expansion ``|a|^2 - 2 a.b + |b|^2``
through ``torch.matmul`` with TF32 off; the TPU's bf16 hi/lo compensated
product (``sqdist_compensated``) is not copied. Serving callers centre both
operands on the cloud centroid first, which keeps the cancellation error
small. :func:`ball_query` is the flat query the training path uses; the
serving path selects patches with the fused stratified query
(:mod:`bufferx_tpu_torch.kernels.strat_pallas`).
"""

from __future__ import annotations

import torch

__all__ = ["sqdist", "masked_sqdist", "nearest_neighbor", "mutual_nearest",
           "ball_query"]

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


def nearest_neighbor(query: torch.Tensor, ref: torch.Tensor,
                     mask_query: torch.Tensor, mask_ref: torch.Tensor):
    """1-NN of each query among the valid refs: (idx [..., M] int64, d2
    [..., M]); ties go to the lowest index."""
    d = masked_sqdist(query, ref, mask_query, mask_ref)
    idx = torch.argmin(d, dim=-1)
    return idx, torch.gather(d, -1, idx[..., None])[..., 0]


def ball_query(pts: torch.Tensor, pts_mask: torch.Tensor,
               centers: torch.Tensor, radius, off: torch.Tensor,
               nsample: int):
    """Random in-radius subset of ``nsample`` points per centre.

    pts [N, 3], pts_mask [N], centers [K, 3], radius a scalar (or 0-d
    tensor), ``off`` [K] ints in [0, N): the centre's cyclic offset into the
    (pre-shuffled) point order, the JAX query's ``randint(key, (K, 1), 0,
    N)`` passed in. A point's priority is its position in the order that
    starts at ``off``, and the ``nsample`` in-radius points of highest
    priority are taken, highest first. Returns (idx [K, nsample] int64,
    valid [K, nsample] bool); invalid slots hold index 0."""
    n = pts.shape[0]
    d2 = sqdist(centers, pts)                                    # [K, N]
    in_radius = (d2 <= radius * radius) & pts_mask[None, :]
    shifted = torch.arange(n, device=pts.device)[None, :] - off[:, None]
    shifted = torch.where(shifted < 0, shifted + n, shifted)
    prio = -shifted.to(torch.float32)                            # in (-n, 0]
    scores = torch.where(in_radius, prio, float("-inf"))
    vals, idx = torch.topk(scores, nsample, dim=-1, sorted=True)
    valid = vals > float("-inf")
    return torch.where(valid, idx, 0), valid


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
