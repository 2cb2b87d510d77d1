"""Cross-scale consensus over per-correspondence pose candidates.

Counterpart of :func:`bufferx_tpu.solver.consensus.cross_scale_consensus`:
each candidate counts the valid correspondences it brings within
``thr_j = ||ss_j|| * pi / azi_n * inlier_th``; the best candidate's inlier
set (ties to the lowest index) seeds the pose solver. Candidates are scored
in chunks to bound the [chunk, C, 3] transient.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cross_scale_consensus"]


def cross_scale_consensus(R_cand, t_cand, ss_kpts, tt_kpts, valid,
                          azi_n: int, inlier_th: float, chunk: int = 512):
    """Returns (inlier_mask [C], best_idx, best_count)."""
    thr = torch.linalg.norm(ss_kpts, dim=-1) * (math.pi / azi_n) * inlier_th
    counts = []
    for i in range(0, R_cand.shape[0], chunk):
        Rc, tc = R_cand[i:i + chunk], t_cand[i:i + chunk]
        warped = torch.einsum("hij,cj->hci", Rc, ss_kpts) + tc[:, None, :]
        d = torch.linalg.norm(warped - tt_kpts[None], dim=-1)
        n_in = torch.sum((d < thr[None]) & valid[None], dim=-1)
        counts.append(torch.where(valid[i:i + chunk], n_in,
                                  torch.full_like(n_in, -1)))
    counts = torch.cat(counts)
    best = torch.argmax(counts)
    warped_best = torch.matmul(ss_kpts, R_cand[best].t()) + t_cand[best]
    d_best = torch.linalg.norm(warped_best - tt_kpts, dim=-1)
    return (d_best < thr) & valid, best, counts[best]
