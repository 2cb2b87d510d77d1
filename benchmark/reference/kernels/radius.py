"""Density-aware descriptor radius estimation.

Frozen copy of the program's ``kernels/radius.py``: targets are
percentages of the FULL pair count while only pairs within ``max_r`` are
counted; 12 bisection rounds over bf16 distances on the contiguous ``1/subsample`` column prefix (points arrive
shuffled, so a prefix is a uniform subset); the result is rounded to
2 decimals.
"""

from __future__ import annotations

import torch

from benchmark.reference.device import constant

__all__ = ["density_aware_radius_from_d2"]


def _bisect_quantile(d2, weights, target_counts, min_r: float, max_r: float,
                     num_iters: int = 12) -> torch.Tensor:
    """d2, weights [B, K, N]; target_counts [B, T] -> [B, T]."""
    b, t = target_counts.shape
    inf = torch.full_like(d2, float("inf"))
    d_b = torch.sqrt(torch.where(weights, d2, inf)).to(torch.bfloat16)
    low = torch.full((b, t), min_r, dtype=torch.float32, device=d2.device)
    high = torch.full((b, t), max_r, dtype=torch.float32, device=d2.device)
    for _ in range(num_iters):
        mid = (0.5 * (low + high)).to(torch.bfloat16)
        counts = torch.stack(
            [torch.count_nonzero(d_b < mid[:, i, None, None], dim=(1, 2))
             for i in range(t)], dim=1,
        ).to(torch.float32)
        mid = mid.to(torch.float32)
        low = torch.where(counts < target_counts, mid, low)
        high = torch.where(counts >= target_counts, mid, high)
    return 0.5 * (low + high)


def density_aware_radius_from_d2(d2: torch.Tensor, pts_mask: torch.Tensor,
                                 kpts_mask: torch.Tensor, thresholds,
                                 max_r: float = 5.0,
                                 subsample: int = 1) -> torch.Tensor:
    """Per-scale radii [B, len(thresholds)] f32 from a batch of distance
    matrices: d2 [B, K, N], pts_mask [B, N], kpts_mask [B, K]."""
    if subsample > 1:
        keep = d2.shape[2] // subsample
        d2 = d2[:, :, :keep]
        pts_mask = pts_mask[:, :keep]
    w = kpts_mask[:, :, None] & pts_mask[:, None, :] & (d2 <= max_r * max_r)
    total = (kpts_mask.sum(dim=1).to(torch.float32)
             * pts_mask.sum(dim=1).to(torch.float32))
    targets = constant([th / 100.0 for th in thresholds], torch.float32,
                       d2.device) * total[:, None]
    r = _bisect_quantile(d2, w, targets, 0.0, max_r)
    return torch.round(r * 100.0) / 100.0
