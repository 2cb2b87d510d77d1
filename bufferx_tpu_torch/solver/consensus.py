"""Cross-scale consensus over per-correspondence pose candidates.

Counterpart of :func:`bufferx_tpu.solver.consensus.cross_scale_consensus`:
each candidate counts the valid correspondences it brings within
``thr_j = ||ss_j|| * pi / azi_n * inlier_th``; the best candidate's inlier
set (ties to the lowest index) seeds the pose solver. The candidates are
scored by :func:`bufferx_tpu_torch.kernels.hyp_score.hyp_score` (K6 on the
card; on the CPU the eager loop, in chunks that bound its [B, chunk, C, 3]
transient). A leading pair dimension takes the place of the JAX package's
``vmap``.
"""

from __future__ import annotations

import math

import torch

from bufferx_tpu_torch.core.linalg import take_rows
from bufferx_tpu_torch.kernels.hyp_score import hyp_score

__all__ = ["cross_scale_consensus"]


def cross_scale_consensus(R_cand, t_cand, ss_kpts, tt_kpts, valid,
                          azi_n: int, inlier_th: float, chunk: int = 512):
    """A batch of pairs: R_cand [B, C, 3, 3], t_cand/ss_kpts/tt_kpts
    [B, C, 3], valid [B, C] -> (inlier_mask [B, C], best_idx [B],
    best_count [B])."""
    thr = torch.linalg.norm(ss_kpts, dim=-1) * (math.pi / azi_n) * inlier_th
    counts = hyp_score(R_cand, t_cand, ss_kpts, tt_kpts, thr, valid, valid,
                       chunk)
    best = torch.argmax(counts, dim=1)                           # [B]
    R_best = take_rows(R_cand, best[:, None])[:, 0]              # [B, 3, 3]
    t_best = take_rows(t_cand, best[:, None])                    # [B, 1, 3]
    warped_best = torch.matmul(ss_kpts, R_best.transpose(1, 2)) + t_best
    d_best = torch.linalg.norm(warped_best - tt_kpts, dim=-1)
    return ((d_best < thr) & valid, best,
            torch.gather(counts, 1, best[:, None])[:, 0])
