"""Density-based clutter prefilter, for a stack of clouds.

Counterpart of :mod:`bufferx_tpu.kernels.density` (plain ``jnp`` there, so
plain torch ops here), with a leading cloud dimension. Volumetric outlier
clutter captures farthest-point sampling's keypoints (FPS picks isolated
points first), so the indoor presets drop low-density points before FPS:

1. the squared distances of the first ``num_anchors`` slots (``prepare_cloud``
   shuffles the points, so they are a uniform sample) to every slot; the
   median over valid anchors of the nearest other point's distance is the
   spacing ``s`` (slots at d2 <= 1e-12, the anchor itself and duplicates of
   it, do not count as neighbours);
2. per point the count of anchors within ``alpha * s``;
3. keep points whose count is at least ``beta`` times the median count;
4. guard: where that would keep under ``min_keep_frac`` of a cloud, the
   cloud keeps its mask.

Step by step as the JAX function, without centring the operands (it does
not centre either), so both round alike wherever the two d2 products do.
The guard is a ``torch.where``: nothing is read back to the host.
"""

from __future__ import annotations

import torch

from benchmark.reference.kernels.neighbors import masked_sqdist

__all__ = ["density_inlier_mask"]

_BIG = 1e12


def _masked_median(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per row, the ``(n - 1) // 2``-th of the ascending valid values
    (invalid ones sort last as +inf); [C, M], [C, M] -> [C]."""
    v = torch.sort(vals.masked_fill(~mask, float("inf")), dim=-1).values
    idx = torch.clamp((mask.sum(dim=-1) - 1) // 2, 0, vals.shape[-1] - 1)
    return torch.gather(v, 1, idx[:, None])[:, 0]


def density_inlier_mask(xyz: torch.Tensor, mask: torch.Tensor,
                        num_anchors: int = 2048, alpha: float = 8.0,
                        beta: float = 0.25,
                        min_keep_frac: float = 0.5) -> torch.Tensor:
    """Refined validity masks with low-density (clutter) slots removed:
    xyz [C, N, 3] padded clouds, mask [C, N] -> [C, N] bool.

    Memory: one f32 ``[C, min(num_anchors, N), N]`` block (247 MB a cloud at
    N = 30208) and, while the spacing is taken, a second one; the count
    sums a bool compare along the anchor axis."""
    m = min(num_anchors, xyz.shape[1])
    amask = mask[:, :m]
    d2 = masked_sqdist(xyz[:, :m], xyz, amask, mask)             # [C, m, N]

    nn2 = torch.where(d2 > 1e-12, d2, _BIG).amin(dim=-1)         # [C, m]
    spacing2 = _masked_median(nn2, amask)
    del nn2

    r2 = (alpha * alpha) * spacing2
    cnt = (d2 <= r2[:, None, None]).sum(dim=1)                   # [C, N]
    del d2
    med_cnt = _masked_median(cnt.to(torch.float32), mask)
    keep = mask & (cnt >= beta * med_cnt[:, None])

    frac = keep.sum(dim=1) / torch.clamp_min(mask.sum(dim=1), 1)
    return torch.where((frac >= min_keep_frac)[:, None], keep, mask)
