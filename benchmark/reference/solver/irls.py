"""IRLS pose refinement (PointDSC-style post refinement).

Counterpart of :func:`bufferx_tpu.solver.irls.post_refinement`: a fixed
number of rounds of inlier re-selection under ``dist_th`` with Cauchy-like
weights ``1 / (1 + (d / dist_th)^2)`` and a weighted-Kabsch re-estimate; a
round that finds fewer than 3 inliers keeps the previous pose. Every
argument may carry leading batch dimensions (the pairs of a batch); nothing
here reads a value back to the host.
"""

from __future__ import annotations

import torch

from benchmark.reference.core.linalg import kabsch
from benchmark.reference.core.se3 import decompose, integrate, transform

__all__ = ["post_refinement"]


def post_refinement(pose: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
                    valid: torch.Tensor, dist_th: float,
                    num_iters: int = 20) -> torch.Tensor:
    """pose [..., 4, 4], src/tgt [..., C, 3], valid [..., C] ->
    refined pose [..., 4, 4]."""
    T = pose
    for _ in range(num_iters):
        d = torch.linalg.norm(transform(src, T) - tgt, dim=-1)
        inlier = (d < dist_th) & valid
        w = inlier.to(src.dtype) / (1.0 + (d / dist_th) ** 2)
        R, t = kabsch(src, tgt, w)
        # keep the previous pose if the inlier set collapses
        ok = torch.sum(inlier, dim=-1) >= 3
        R0, t0 = decompose(T)
        T = integrate(torch.where(ok[..., None, None], R, R0),
                      torch.where(ok[..., None], t, t0))
    return T
