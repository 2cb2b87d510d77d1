"""Fused multi-radius stratified ball query: CUDA kernel K2 + plain version.

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

import ctypes

import torch

from bufferx_tpu_torch.cuda_build import CudaKernel, ptr, register, require_cuda

__all__ = [
    "STRAT_KERNEL",
    "QBITS",
    "quantize",
    "decode",
    "strat_packed_plain",
    "strat_packed_cuda",
    "ball_query_stratified_multi",
]

QBITS = 24
QMASK = (1 << QBITS) - 1
_V, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
STRAT_KERNEL = register(CudaKernel(
    "strat", "strat.cu", replaces="bufferx_tpu/kernels/strat_pallas.py:104",
    entry="bx_strat",
    argtypes=[_V, _V, _V, _V, _I, _LL, _I, _I, _I, _I, _V],
))


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


def strat_packed_plain(d2, q_t, off, radii2) -> torch.Tensor:
    """Plain version: d2 [C, K, L*S], q_t [C, 3, L, S], off [C, K, S],
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


def strat_packed_cuda(d2, q_t, off, radii2) -> torch.Tensor:
    """K2 on the card; same contract as :func:`strat_packed_plain`, one
    launch for all C clouds. ``d2`` may be a view whose clouds lie further
    apart than K rows (``full[:, :K]`` of a [C, K', N] matrix): each
    cloud's [K, L*S] block must itself be contiguous."""
    if d2.ndim != 3 or q_t.ndim != 4 or off.ndim != 3 or radii2.ndim != 2:
        raise ValueError(
            "strat kernel expects d2 [C, K, N], q [C, 3, L, S], off [C, K, S] "
            f"and radii2 [C, R], got {tuple(d2.shape)}, {tuple(q_t.shape)}, "
            f"{tuple(off.shape)} and {tuple(radii2.shape)}")
    c_n, kq, n = d2.shape
    _, _, l, s = q_t.shape
    num_r = radii2.shape[1]
    if not 1 <= num_r <= 4:
        raise ValueError(f"strat kernel takes 1..4 radii, got {num_r}")
    if not 1 <= l < 1 << (31 - QBITS):
        raise ValueError(f"strat kernel takes 1 <= L < 128 strips, got {l}")
    if (q_t.shape != (c_n, 3, l, s) or n != l * s
            or off.shape != (c_n, kq, s) or radii2.shape[0] != c_n):
        raise ValueError(
            f"strat kernel: shapes disagree: d2 {tuple(d2.shape)}, q "
            f"{tuple(q_t.shape)}, off {tuple(off.shape)}, radii2 "
            f"{tuple(radii2.shape)}")
    for t, dt, name in ((q_t, torch.int32, "q"), (off, torch.int32, "off"),
                        (radii2, torch.float32, "radii2")):
        require_cuda(t, dt, f"strat {name}")
    if not d2.is_cuda or d2.dtype != torch.float32:
        raise ValueError(f"strat d2: expected a CUDA float32 tensor, got "
                         f"{d2.dtype} on {d2.device}")
    if not ((n == 1 or d2.stride(2) == 1) and (kq == 1 or d2.stride(1) == n)):
        raise ValueError("strat d2: each cloud's [K, N] block must be "
                         f"contiguous, got strides {d2.stride()}")
    out = torch.empty((c_n, num_r, 3, kq, s), dtype=torch.int32,
                      device=d2.device)
    if c_n and kq:
        STRAT_KERNEL.launch(ptr(d2), ptr(off), ptr(q_t), ptr(radii2), c_n,
                            d2.stride(0) if c_n > 1 else 0, num_r, kq, l, s,
                            ptr(out))
    return out


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
    if d2.is_cuda:
        packed = strat_packed_cuda(d2, q_t, off, radii2)
    elif d2.device.type == "cpu":
        packed = strat_packed_plain(d2, q_t, off, radii2)
    else:
        raise ValueError(f"strat: unsupported device {d2.device}")
    return decode(packed, centers, lo, res, l)
