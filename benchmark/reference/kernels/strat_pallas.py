"""Fused multi-radius stratified ball query, plain PyTorch (frozen copy of
the port's K2 plain version).

Counterpart of :mod:`bufferx_tpu.kernels.strat_pallas` (same module name).
A cloud's N points are viewed as L = N/S strips of S slots; for every
centre, slot and radius the first in-radius point in cyclic order from a
random per-(centre, slot) offset wins. The winner is the minimum of the
packed int32 ``rank << 24 | quantized_coord`` per coordinate, and the
coordinates decode from the 24-bit bounding-box quantization outside the
kernel. Every function takes a leading cloud dimension C (the JAX package
maps its single-cloud function over clouds with ``vmap``): one pair is
C = 2 (source and target), a batch of B pairs C = 2B, one kernel launch
either way. The strip offsets ``off [C, K, S]`` are an explicit argument:
the caller draws them with a ``torch.Generator`` (or a test passes in
JAX's). Kernel and plain version are bit-exact on the packed result.
"""

from __future__ import annotations

import torch

__all__ = ["QBITS", "quantize", "decode", "strat_packed",
           "ball_query_stratified_multi"]

QBITS = 24
QMASK = (1 << QBITS) - 1


def quantize(pts: torch.Tensor, mask: torch.Tensor):
    """Per-cloud, per-coordinate bounding-box quantization over VALID rows
    to QBITS: pts [C, N, 3], mask [C, N] -> (q [C, N, 3] int32, lo [C, 3],
    res [C, 3])."""
    m = mask[..., None]
    inf = torch.full_like(pts, float("inf"))
    lo = torch.amin(torch.where(m, pts, inf), dim=1)
    hi = torch.amax(torch.where(m, pts, -inf), dim=1)
    # all-invalid cloud: a degenerate box at the origin
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    hi = torch.where(torch.isfinite(hi), hi, torch.zeros_like(hi))
    res = torch.clamp_min(hi - lo, 1e-9) / float(QMASK)
    q = torch.clamp(torch.round((pts - lo[:, None]) / res[:, None]), 0,
                    QMASK).to(torch.int32)
    return q, lo, res


def decode(packed: torch.Tensor, centers: torch.Tensor, lo: torch.Tensor,
           res: torch.Tensor, l: int):
    """packed [C, R, 3, K, S], centers [C, K, 3], lo/res [C, 3] ->
    (patches [C, R, K, S, 3], valid [C, R, K, S])."""
    valid = (packed[:, :, 0] >> QBITS) < l
    q = (packed & QMASK).to(torch.float32)
    x = lo[:, None, :, None, None] + q * res[:, None, :, None, None]
    patches = torch.movedim(x, 2, -1)
    patches = torch.where(
        valid[..., None], patches,
        centers[:, None, :, None, :].expand_as(patches),
    )
    return patches, valid


def strat_packed(d2, q_t, off, radii2) -> torch.Tensor:
    """d2 [C, K, L*S], q_t [C, 3, L, S], off [C, K, S],
    radii2 [C, R] -> packed [C, R, 3, K, S] int32 (cloud by cloud, to bound
    the [K, L, S] intermediates)."""
    kq = d2.shape[1]
    _, _, l, s = q_t.shape
    pos = torch.arange(l, dtype=torch.int32, device=d2.device)[None, :, None]
    clouds = []
    for c in range(d2.shape[0]):
        d2s = d2[c].reshape(kq, l, s)
        rank = pos - off[c][:, None, :]
        rank = torch.where(rank < 0, rank + l, rank)          # [K, L, S]
        outs = []
        for r in range(radii2.shape[1]):
            score = torch.where(d2s <= radii2[c, r], rank,
                                torch.full_like(rank, l))
            base = score << QBITS
            outs.append(torch.stack(
                [torch.amin(base + q_t[c, x][None], dim=1) for x in range(3)]
            ))
        clouds.append(torch.stack(outs))
    return torch.stack(clouds)


def ball_query_stratified_multi(pts, pts_mask, centers, radii, off,
                                nsample: int, d2):
    """Stratified ball query for ALL radii in one pass over ``d2``, for C
    clouds at once.

    pts [C, N, 3], pts_mask [C, N] (already folded into d2's fill), centers
    [C, K, 3], radii [C, R], off [C, K, S] int32 in [0, N/S), d2 [C, K, N]
    masked squared distances (a view with a larger cloud stride is taken as
    it is). Returns (patches [C, R, K, S, 3], valid [C, R, K, S]).
    """
    c_n, kq, n = d2.shape
    s = nsample
    if n % s != 0:
        raise ValueError(f"nsample {s} must divide the cloud capacity {n}")
    l = n // s
    # scores run 0..l inclusive and must fit above the 24 coordinate bits
    if l >= 1 << (31 - QBITS):
        raise ValueError(
            f"max_points/nsample = {l} overflows the packed int32 encoding "
            f"(must be < {1 << (31 - QBITS)})"
        )
    if off.shape != (c_n, kq, s):
        raise ValueError(
            f"off must be [{c_n}, {kq}, {s}], got {tuple(off.shape)}")
    q, lo, res = quantize(pts, pts_mask)
    q_t = q.reshape(c_n, l, s, 3).permute(0, 3, 1, 2).contiguous()
    radii2 = (radii * radii).to(torch.float32).contiguous()
    off = off.to(torch.int32).contiguous()
    packed = strat_packed(d2, q_t, off, radii2)
    return decode(packed, centers, lo, res, l)
