"""Patch extraction around keypoints.

Counterpart of :func:`bufferx_tpu.geometry.patches.select_patches`: up to
``patch_sample`` random in-radius points per keypoint; slots with no point
get the keypoint's own coordinates, so their keypoint-relative offset is
exactly zero. The query is chosen as the JAX package chooses it
(:func:`patch_query`): the single-radius stratified query, then the block
query, then the flat one, and a query that was asked for but cannot run
warns before the next one is taken. The serving path's default is none of
these: the fused multi-radius stratified query
(:func:`bufferx_tpu_torch.kernels.strat_pallas.ball_query_stratified_multi`)
selects every scale's patches at once where it can.
"""

from __future__ import annotations

import warnings

import torch

from bufferx_tpu_torch.kernels.neighbors import (
    take_points,
    ball_query,
    ball_query_blocks,
    ball_query_stratified,
)

__all__ = ["select_patches", "patch_query", "offset_bounds"]


def patch_query(n: int, patch_sample: int, has_d2: bool,
                use_blocks: bool = False, block: int = 32,
                cand_blocks: int = 64, use_strat: bool = False) -> str:
    """The query :func:`select_patches` runs for these arguments: "strat",
    "blocks" or "flat" (the JAX function's conditions, in its order)."""
    if use_strat and has_d2 and n % patch_sample == 0:
        return "strat"
    if (use_blocks and has_d2 and n % block == 0
            and min(cand_blocks, n // block) * block >= patch_sample):
        return "blocks"
    return "flat"


def offset_bounds(kind: str, n: int, patch_sample: int, block: int = 32,
                  cand_blocks: int = 64) -> tuple:
    """The exclusive upper bounds of the query's random offsets: "flat" one
    [K] set in [0, N); "blocks" two [K] sets, in [0, N / block) and in
    [0, cand_blocks * block); "strat" one [K, patch_sample] set in
    [0, N / patch_sample)."""
    if kind == "flat":
        return (n,)
    if kind == "blocks":
        return (n // block, min(cand_blocks, n // block) * block)
    if kind == "strat":
        return (n // patch_sample,)
    raise ValueError(f"unknown patch query {kind!r}")


def select_patches(pts: torch.Tensor, pts_mask: torch.Tensor,
                   kpts: torch.Tensor, radius, off: torch.Tensor,
                   patch_sample: int, d2: torch.Tensor | None = None,
                   use_blocks: bool = False, block: int = 32,
                   cand_blocks: int = 64, use_strat: bool = False):
    """(patches [K, P, 3] absolute coordinates, patch_mask [K, P]) for
    keypoints [K, 3] in the cloud [N, 3], or with a leading cloud dimension
    C on the clouds, keypoints, offsets and ``d2`` (``radius`` then a number
    or one a cloud [C]).

    ``d2`` [(C,) K, N]: the keypoint-to-cloud squared distances, which the
    block and the stratified query need. ``off``: the chosen query's
    offsets (:func:`offset_bounds`): [(C,) K] for the flat query, [(C,) 2,
    K] for the block query, [(C,) K, P] for the stratified one.
    ``use_strat`` asks for the single-radius stratified query (it needs
    ``d2`` and N % P == 0), ``use_blocks`` for the block query (it needs
    ``d2``, N % block == 0 and enough candidates); either one that cannot
    run warns, as in the JAX package, and the next is taken."""
    n = pts.shape[-2]
    kind = patch_query(n, patch_sample, d2 is not None, use_blocks, block,
                       cand_blocks, use_strat)
    if kind == "strat":
        return ball_query_stratified(pts, pts_mask, kpts, radius, off,
                                     patch_sample, d2)
    if use_strat:
        warnings.warn(
            "select_patches: stratified ball query requested but falling "
            f"back (n={n}, patch_sample={patch_sample}, "
            f"d2={'set' if d2 is not None else 'None'}) — make "
            "capacity.max_points divisible by patch.num_points_per_patch "
            "and pass d2, or choose another ball-query path explicitly.",
            stacklevel=2,
        )
    if kind == "blocks":
        return ball_query_blocks(pts, pts_mask, kpts, radius, off,
                                 patch_sample, d2, block=block,
                                 cand_blocks=min(cand_blocks, n // block))
    if use_blocks:
        # a silent fallback once let a configuration claim the block query
        # while the flat one ran: the two differ in cost and in capture
        warnings.warn(
            "select_patches: block ball query requested but falling back to "
            f"the flat path (n={n}, block={block}, cand_blocks={cand_blocks}"
            f", patch_sample={patch_sample}, "
            f"d2={'set' if d2 is not None else 'None'}) — "
            "make capacity.max_points divisible by patch.bq_block and pass "
            "d2, or set patch.block_ball_query=False explicitly.",
            stacklevel=2,
        )
    idx, valid = ball_query(pts, pts_mask, kpts, radius, off, patch_sample,
                            d2=d2)
    if pts.ndim == 2:
        gathered = pts[idx]                                      # [K, P, 3]
    else:
        gathered = take_points(pts, idx)                        # [C, K, P, 3]
    patches = torch.where(valid[..., None], gathered, kpts[..., :, None, :])
    return patches, valid
