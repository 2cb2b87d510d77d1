"""Density-aware descriptor radius estimation from a distance matrix.

Counterpart of :func:`bufferx_tpu.kernels.radius.density_aware_radius_from_d2`
with the same semantics: targets are percentages of the FULL pair count
while only pairs within ``max_r`` are counted; 12 bisection rounds over bf16
distances on the contiguous ``1/subsample`` column prefix (points arrive
shuffled, so a prefix is a uniform subset); the result is rounded to
2 decimals.
"""

from __future__ import annotations

import torch

__all__ = ["density_aware_radius_from_d2"]


def _bisect_quantile(d2, weights, target_counts, min_r: float, max_r: float,
                     num_iters: int = 12) -> torch.Tensor:
    t = target_counts.shape[0]
    inf = torch.full_like(d2, float("inf"))
    d_b = torch.sqrt(torch.where(weights, d2, inf)).to(torch.bfloat16)
    low = torch.full((t,), min_r, dtype=torch.float32, device=d2.device)
    high = torch.full((t,), max_r, dtype=torch.float32, device=d2.device)
    for _ in range(num_iters):
        mid = (0.5 * (low + high)).to(torch.bfloat16)
        counts = torch.stack(
            [torch.count_nonzero(d_b < mid[i]) for i in range(t)]
        ).to(torch.float32)
        mid = mid.to(torch.float32)
        low = torch.where(counts < target_counts, mid, low)
        high = torch.where(counts >= target_counts, mid, high)
    return 0.5 * (low + high)


def density_aware_radius_from_d2(d2: torch.Tensor, pts_mask: torch.Tensor,
                                 kpts_mask: torch.Tensor, thresholds,
                                 max_r: float = 5.0,
                                 subsample: int = 1) -> torch.Tensor:
    """Per-scale radii [len(thresholds)] f32 from a [K, N] distance matrix."""
    if subsample > 1:
        keep = d2.shape[1] // subsample
        d2 = d2[:, :keep]
        pts_mask = pts_mask[:keep]
    w = kpts_mask[:, None] & pts_mask[None, :] & (d2 <= max_r * max_r)
    total = (kpts_mask.sum().to(torch.float32)
             * pts_mask.sum().to(torch.float32))
    targets = torch.tensor(
        [th / 100.0 for th in thresholds], dtype=torch.float32,
        device=d2.device,
    ) * total
    r = _bisect_quantile(d2, w, targets, 0.0, max_r)
    return torch.round(r * 100.0) / 100.0
