"""Massively parallel correspondence RANSAC.

Counterpart of :func:`bufferx_tpu.solver.ransac.ransac_pose`: a fixed budget
of minimal 3-point sets drawn uniformly from the sampling pool by rank
selection, solved all at once by Horn/Kabsch, filtered by Open3D's
edge-length and distance checkers, scored against every evaluated
correspondence (:func:`bufferx_tpu_torch.kernels.hyp_score.hyp_score`: K6 on
the card, the eager chunk loop on the CPU), and the winner refit by weighted
Kabsch on its inliers.

A leading pair dimension takes the place of the JAX package's ``vmap``.
The draws are explicit: ``rank_draws [B, H, 3]`` holds uniform integers in
[0, 2^30) (reduced modulo the pool size here, as the JAX solver reduces its
``randint`` draw). A test passes JAX's draw; by default they come from a
``torch.Generator``.

While tracing is on (:mod:`bufferx_tpu_torch.utils.timers`) each call adds
the hypotheses it scores, B x H from the draws' shape, to the host counter
:data:`HYPOTHESES`; nothing is read from the device for it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bufferx_tpu_torch.core.linalg import kabsch, take_rows
from bufferx_tpu_torch.core.se3 import integrate
from bufferx_tpu_torch.kernels.hyp_score import hyp_score
from bufferx_tpu_torch.utils.timers import count

__all__ = ["RansacResult", "ransac_pose", "hypotheses", "draw_ranks",
           "RANK_RANGE", "HYPOTHESES"]

RANK_RANGE = 1 << 30
# the host counter of the hypotheses scored (utils.timers.counters)
HYPOTHESES = "ransac.hypotheses"


class RansacResult(NamedTuple):
    pose: torch.Tensor          # [B, 4, 4]
    num_inliers: torch.Tensor   # [B] int64
    inlier_mask: torch.Tensor   # [B, C]


def draw_ranks(num_hypotheses: int, generator: torch.Generator, device,
               batch: int = 1) -> torch.Tensor:
    """Uniform rank draws [batch, H, 3] in [0, 2^30) from ``generator``."""
    return torch.randint(
        0, RANK_RANGE, (batch, num_hypotheses, 3), generator=generator,
        device=generator.device, dtype=torch.int64,
    ).to(device)


def hypotheses(src, tgt, pool_mask, eval_mask, rank_draws, dist_th: float,
               similar_th: float = 0.8):
    """The minimal sets of :func:`ransac_pose` solved and checked: (R
    [B, H, 3, 3], t [B, H, 3], hyp_ok [B, H] bool, Open3D's edge-length and
    distance checkers both passed)."""
    # empty pool: fall back to eval_mask, then to everything
    pool = torch.where(
        pool_mask.any(dim=1, keepdim=True), pool_mask,
        torch.where(eval_mask.any(dim=1, keepdim=True), eval_mask,
                    torch.ones_like(pool_mask)),
    )
    cum = torch.cumsum(pool.to(torch.int64), dim=1)              # inclusive
    npool = torch.clamp_min(cum[:, -1], 1)
    ranks = rank_draws.to(torch.int64) % npool[:, None, None]    # [B, H, 3]
    b, h, _ = ranks.shape
    # idx = #{cum <= rank}: the rank-th pool member
    sel = torch.searchsorted(cum, ranks.reshape(b, h * 3), right=True)
    a = take_rows(src, sel).reshape(b, h, 3, 3)                  # [B, H, 3, 3]
    bb = take_rows(tgt, sel).reshape(b, h, 3, 3)

    # Open3D CorrespondenceCheckerBasedOnEdgeLength
    ea = torch.linalg.norm(a - torch.roll(a, 1, dims=2), dim=-1)
    eb = torch.linalg.norm(bb - torch.roll(bb, 1, dims=2), dim=-1)
    ratio = torch.minimum(ea, eb) / torch.clamp_min(torch.maximum(ea, eb), 1e-12)
    edge_ok = torch.all(ratio > similar_th, dim=-1)

    R, t = kabsch(a, bb)                                         # [B, H, 3, 3]

    # Open3D CorrespondenceCheckerBasedOnDistance on the minimal set
    wa = torch.matmul(a, R.transpose(-1, -2)) + t[:, :, None, :]
    dist_ok = torch.all(torch.linalg.norm(wa - bb, dim=-1) <= dist_th, dim=-1)
    return R, t, edge_ok & dist_ok


def ransac_pose(src, tgt, pool_mask, eval_mask, rank_draws, dist_th: float,
                similar_th: float = 0.8, chunk: int = 2048) -> RansacResult:
    """A batch of pairs: src/tgt [B, C, 3]; pool_mask (sampling pool) and
    eval_mask (scored set) [B, C] bool; rank_draws [B, H, 3] int in
    [0, 2^30). ``chunk``: hypotheses a pass of the plain scoring on the CPU
    (the kernel scores all at once). Nothing here reads a value back to the
    host."""
    b, h, _ = rank_draws.shape
    count(HYPOTHESES, b * h)
    R, t, hyp_ok = hypotheses(src, tgt, pool_mask, eval_mask, rank_draws,
                              dist_th, similar_th)
    scores = hyp_score(R, t, src, tgt, dist_th, eval_mask, hyp_ok, chunk)
    best = torch.argmax(scores, dim=1)                           # [B]
    R_best = take_rows(R, best[:, None])[:, 0]                   # [B, 3, 3]
    t_best = take_rows(t, best[:, None])[:, 0]                   # [B, 3]

    warped = torch.matmul(src, R_best.transpose(1, 2)) + t_best[:, None]
    inliers = (torch.linalg.norm(warped - tgt, dim=-1) < dist_th) & eval_mask
    w = inliers.to(src.dtype)
    R_fit, t_fit = kabsch(src, tgt, w)
    enough = torch.sum(w, dim=1) >= 3
    R_out = torch.where(enough[:, None, None], R_fit, R_best)
    t_out = torch.where(enough[:, None], t_fit, t_best)

    warped2 = torch.matmul(src, R_out.transpose(1, 2)) + t_out[:, None]
    final = (torch.linalg.norm(warped2 - tgt, dim=-1) < dist_th) & eval_mask
    return RansacResult(integrate(R_out, t_out), torch.sum(final, dim=1), final)
