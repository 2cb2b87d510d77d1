"""Patch extraction around keypoints with the flat ball query.

Counterpart of :func:`bufferx_tpu.geometry.patches.select_patches` on its
flat path (the one training takes): up to ``patch_sample`` random in-radius
points per keypoint; slots with no point get the keypoint's own coordinates,
so their keypoint-relative offset is exactly zero. The serving path selects
its patches with the fused stratified query instead
(:func:`bufferx_tpu_torch.kernels.strat_pallas.ball_query_stratified_multi`).
"""

from __future__ import annotations

import torch

from bufferx_tpu_torch.kernels.neighbors import ball_query

__all__ = ["select_patches"]


def select_patches(pts: torch.Tensor, pts_mask: torch.Tensor,
                   kpts: torch.Tensor, radius, off: torch.Tensor,
                   patch_sample: int, use_blocks: bool = False,
                   use_strat: bool = False):
    """(patches [K, P, 3] absolute coordinates, patch_mask [K, P]) for
    keypoints [K, 3] in the cloud [N, 3]; ``off`` [K] are the query's cyclic
    offsets (:func:`~bufferx_tpu_torch.kernels.neighbors.ball_query`).
    The block query and the single-radius stratified query of the JAX
    package are not ported and raise."""
    if use_blocks or use_strat:
        raise NotImplementedError(
            "select_patches: only the flat ball query is ported "
            f"(use_blocks={use_blocks}, use_strat={use_strat})")
    idx, valid = ball_query(pts, pts_mask, kpts, radius, off, patch_sample)
    gathered = pts[idx]                                          # [K, P, 3]
    patches = torch.where(valid[..., None], gathered, kpts[:, None, :])
    return patches, valid
