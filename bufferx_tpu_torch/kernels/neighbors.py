"""Squared distances, nearest neighbours and the patch queries (plain
float32).

Counterpart of :mod:`bufferx_tpu.kernels.neighbors` for the ported path.
The distance matrix is the plain f32 expansion ``|a|^2 - 2 a.b + |b|^2``
through ``torch.matmul`` with TF32 off; the TPU's bf16 hi/lo compensated
product (``sqdist_compensated``) is not copied. Serving callers centre both
operands on the cloud centroid first, which keeps the cancellation error
small.

The three patch queries of the JAX package (:func:`ball_query`, the flat
one the training path uses; :func:`ball_query_blocks`;
:func:`ball_query_stratified`, the single-radius stratified one) are torch
ops here, as they are XLA ops there; each takes a leading cloud dimension
and its random offsets as a tensor. The serving path takes them where the
fused multi-radius stratified query
(:mod:`bufferx_tpu_torch.kernels.strat_pallas`) cannot run
(:mod:`bufferx_tpu_torch.geometry.patches` dispatches).
"""

from __future__ import annotations

import torch

from bufferx_tpu_torch.device import constant

__all__ = ["sqdist", "masked_sqdist", "nearest_neighbor", "mutual_nearest",
           "ball_query", "ball_query_blocks", "ball_query_stratified",
           "take_points"]

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


def _batched(pts, pts_mask, centers):
    """The query's arguments with a leading cloud dimension, and whether it
    was added (a single cloud [N, 3] becomes a batch of one)."""
    single = pts.ndim == 2
    if single:
        pts, pts_mask, centers = pts[None], pts_mask[None], centers[None]
    return pts, pts_mask, centers, single


def _radius_sq(radius, clouds: int, like: torch.Tensor) -> torch.Tensor:
    """radius * radius in float32 as [C, 1, 1]: ``radius`` is a number, a 0-d
    tensor or one radius a cloud [C]."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=like.device)
    return (r * r).expand(clouds).reshape(clouds, 1, 1)


def _cyclic(n: int, off: torch.Tensor) -> torch.Tensor:
    """Position in the cyclic order that starts at ``off``: (i - off) mod n
    for i in [0, n), as [..., n] int32 (``off`` [...] ints in [0, n))."""
    pos = torch.arange(n, device=off.device, dtype=torch.int32)
    shifted = pos - off.to(torch.int32)[..., None]
    return torch.where(shifted < 0, shifted + n, shifted)


def take_points(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts [C, N, 3], idx [C, ...] -> [C, ..., 3]."""
    c = pts.shape[0]
    flat = idx.reshape(c, -1, 1).expand(-1, -1, 3)
    return torch.gather(pts, 1, flat).reshape(idx.shape + (3,))


def ball_query(pts: torch.Tensor, pts_mask: torch.Tensor,
               centers: torch.Tensor, radius, off: torch.Tensor,
               nsample: int, d2: torch.Tensor | None = None):
    """Random in-radius subset of ``nsample`` points per centre.

    pts [N, 3], pts_mask [N], centers [K, 3], radius a scalar (or 0-d
    tensor), ``off`` [K] ints in [0, N): the centre's cyclic offset into the
    (pre-shuffled) point order, the JAX query's ``randint(key, (K, 1), 0,
    N)`` passed in. With a leading cloud dimension C on every argument (and
    ``radius`` a number or [C]) the clouds are queried at once. ``d2``
    [(C,) K, N] optionally supplies the squared centre-to-point distances
    (a view whose rows are further apart is fine). A point's priority is
    its position in the order that starts at ``off``, and the ``nsample``
    in-radius points of highest priority are taken, highest first. Returns
    (idx [(C,) K, nsample] int64, valid [(C,) K, nsample] bool); invalid
    slots hold index 0."""
    pts, pts_mask, centers, single = _batched(pts, pts_mask, centers)
    c, n = pts.shape[0], pts.shape[1]
    if d2 is None:
        d2 = sqdist(centers, pts)                                # [C, K, N]
    elif single:
        d2 = d2[None]
    if single:
        off = off[None]
    in_radius = (d2 <= _radius_sq(radius, c, pts)) & pts_mask[:, None, :]
    prio = _cyclic(n, off).neg_().to(torch.float32)              # (-n, 0]
    scores = prio.masked_fill_(~in_radius, float("-inf"))
    vals, idx = torch.topk(scores, nsample, dim=-1, sorted=True)
    valid = vals > float("-inf")
    idx = torch.where(valid, idx, 0)
    return (idx[0], valid[0]) if single else (idx, valid)


def ball_query_blocks(pts: torch.Tensor, pts_mask: torch.Tensor,
                      centers: torch.Tensor, radius, off: torch.Tensor,
                      nsample: int, d2: torch.Tensor, block: int = 8,
                      cand_blocks: int = 256):
    """Two-level ball query returning patch coordinates: the JAX package's
    ``ball_query_blocks``.

    Level 1 views the cloud as N / block blocks of consecutive points
    (points arrive shuffled, so a block is a random sample) and ranks them
    per centre by their count of points within the radius, tested on ``d2``
    with the radius widened by 1e-5 relative (d2 is the matrix expansion;
    level 2 re-tests the direct difference, and the widening keeps a
    borderline point's block among the candidates), ties broken by a
    random cyclic order of the blocks; the first ``cand_blocks`` become the
    candidates. Level 2 re-tests every candidate point exactly and takes
    ``nsample`` of the in-radius ones in a random cyclic order of the
    candidate slots. ``off`` [(C,) 2, K]: the two levels' cyclic offsets,
    in [0, N / block) and in [0, cand_blocks * block) (the JAX query's
    ``randint`` on the two halves of its key). Returns (patches [(C,) K,
    nsample, 3], valid [(C,) K, nsample]); invalid slots carry the centre's
    own coordinates."""
    pts, pts_mask, centers, single = _batched(pts, pts_mask, centers)
    if single:
        d2, off = d2[None], off[None]
    c, kq, n = pts.shape[0], centers.shape[1], pts.shape[1]
    nb = n // block
    r2 = _radius_sq(radius, c, pts)

    # level 1: blocks ranked by in-radius member count (masked d2 is BIG)
    r2_l1 = r2 * constant((1.0 + 1e-5,), torch.float32, pts.device,
                          shape=()) + 1e-12
    d2b = d2[..., : nb * block].reshape(c, kq, nb, block)
    cnt = (d2b <= r2_l1[..., None]).sum(dim=-1).to(torch.float32)
    frac = 1.0 - _cyclic(nb, off[:, 0]).to(torch.float32) / float(nb)
    bscore = torch.where(cnt > 0.0, cnt + frac, float("-inf"))
    bidx = torch.topk(bscore, cand_blocks, dim=-1, sorted=True).indices

    # the candidates: every point of the chosen blocks, with its validity
    lane = torch.arange(block, device=pts.device)
    cidx = (bidx[..., None] * block + lane).reshape(c, kq, -1)  # [C, K, NC]
    cand = take_points(pts, cidx)                               # [C, K, NC, 3]
    cmask = torch.gather(pts_mask, 1, cidx.reshape(c, -1)).reshape(cidx.shape)

    # level 2: the exact test and a random cyclic priority over the slots
    dx = cand - centers[:, :, None, :]
    sq = dx * dx
    cd2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
    in_r = (cd2 <= r2) & cmask
    nc = cidx.shape[-1]
    prio2 = _cyclic(nc, off[:, 1]).neg_().to(torch.float32)
    scores2 = prio2.masked_fill_(~in_r, float("-inf"))
    vals, sel = torch.topk(scores2, nsample, dim=-1, sorted=True)
    valid = vals > float("-inf")
    sel = torch.where(valid, sel, 0)
    patches = torch.gather(cand, 2, sel[..., None].expand(-1, -1, -1, 3))
    patches = torch.where(valid[..., None], patches, centers[:, :, None, :])
    return (patches[0], valid[0]) if single else (patches, valid)


def ball_query_stratified(pts: torch.Tensor, pts_mask: torch.Tensor,
                          centers: torch.Tensor, radius, off: torch.Tensor,
                          nsample: int, d2: torch.Tensor):
    """Stratified ball query for one radius, returning patch coordinates:
    the JAX package's ``ball_query_stratified``.

    The cloud is viewed as ``nsample`` strided strips (strip s holds the
    points p with p % nsample == s; L = N / nsample points each), and each
    strip gives its first in-radius point in the cyclic order that starts
    at the (centre, strip)'s offset, by a min-reduce over L of the points'
    ranks; a strip with no in-radius point gives an invalid slot. ``off``
    [(C,) K, nsample] ints in [0, L). The winner's coordinates are gathered
    by its index (the JAX function's one-hot sum adds one nonzero product
    to zeros, the same float32 value). This is the query for the shapes the
    fused multi-radius query (:mod:`~bufferx_tpu_torch.kernels.strat_pallas`)
    cannot pack, L >= 128. Requires N % nsample == 0. Returns (patches
    [(C,) K, nsample, 3], valid [(C,) K, nsample])."""
    pts, pts_mask, centers, single = _batched(pts, pts_mask, centers)
    if single:
        d2, off = d2[None], off[None]
    c, kq, n = pts.shape[0], centers.shape[1], pts.shape[1]
    s = nsample
    l = n // s
    in_r = (d2.reshape(c, kq, l, s) <= _radius_sq(radius, c, pts)[..., None]) \
        & pts_mask.reshape(c, 1, l, s)
    # rank of row i in strip s: (i - off) mod L, unique within a strip
    rank = torch.arange(l, device=pts.device, dtype=torch.int32)[:, None] \
        - off.to(torch.int32)[:, :, None, :]                     # [C, K, L, S]
    rank = torch.where(rank < 0, rank + l, rank)
    best = torch.where(in_r, rank, l).amin(dim=2)               # [C, K, S]
    valid = best < l
    row = best + off.to(torch.int32)
    row = torch.where(row >= l, row - l, row)
    idx = row.to(torch.int64) * s + torch.arange(s, device=pts.device)
    patches = take_points(pts, torch.where(valid, idx, 0))
    patches = torch.where(valid[..., None], patches, centers[:, :, None, :])
    return (patches[0], valid[0]) if single else (patches, valid)


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
