"""Fused multi-radius stratified ball query: CUDA kernel K2 + plain version.

Counterpart of :mod:`bufferx_tpu.kernels.strat_pallas` (same module name).
The cloud's N points are viewed as L = N/S strips of S slots; for every
centre, slot and radius the first in-radius point in cyclic order from a
random per-(centre, slot) offset wins. The winner is found with one packed
int32 min-reduction, ``rank << 24 | quantized_coord`` per coordinate, and
the coordinates decode from the 24-bit bounding-box quantization outside
the kernel. The strip offsets ``off [K, S]`` are an explicit argument: the
caller draws them with a ``torch.Generator`` (or a test passes in JAX's).
Kernel and plain version are bit-exact on the packed result.
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
_V, _I = ctypes.c_void_p, ctypes.c_int
STRAT_KERNEL = register(CudaKernel(
    "strat", "strat.cu", replaces="bufferx_tpu/kernels/strat_pallas.py:104",
    entry="bx_strat", argtypes=[_V, _V, _V, _V, _I, _I, _I, _I, _V],
))


def quantize(pts: torch.Tensor, mask: torch.Tensor):
    """Per-coordinate bounding-box quantization over VALID rows to QBITS.

    Returns (q [N, 3] int32, lo [3], res [3])."""
    m = mask[:, None]
    inf = torch.full_like(pts, float("inf"))
    lo = torch.amin(torch.where(m, pts, inf), dim=0)
    hi = torch.amax(torch.where(m, pts, -inf), dim=0)
    # all-invalid cloud: a degenerate box at the origin
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    hi = torch.where(torch.isfinite(hi), hi, torch.zeros_like(hi))
    res = torch.clamp_min(hi - lo, 1e-9) / float(QMASK)
    q = torch.clamp(torch.round((pts - lo) / res), 0, QMASK).to(torch.int32)
    return q, lo, res


def decode(packed: torch.Tensor, centers: torch.Tensor, lo: torch.Tensor,
           res: torch.Tensor, l: int):
    """packed [R, 3, K, S] -> (patches [R, K, S, 3], valid [R, K, S])."""
    valid = (packed[:, 0] >> QBITS) < l
    q = (packed & QMASK).to(torch.float32)
    x = lo[None, :, None, None] + q * res[None, :, None, None]
    patches = torch.movedim(x, 1, -1)
    patches = torch.where(
        valid[..., None], patches, centers[None, :, None, :].expand_as(patches)
    )
    return patches, valid


def strat_packed_plain(d2, q_t, off, radii2) -> torch.Tensor:
    """Plain version: d2 [K, L*S], q_t [3, L, S], off [K, S], radii2 [R]
    -> packed [R, 3, K, S] int32."""
    kq = d2.shape[0]
    _, l, s = q_t.shape
    d2s = d2.reshape(kq, l, s)
    pos = torch.arange(l, dtype=torch.int32, device=d2.device)[None, :, None]
    rank = pos - off[:, None, :]
    rank = torch.where(rank < 0, rank + l, rank)              # [K, L, S]
    outs = []
    for r in range(radii2.shape[0]):
        score = torch.where(d2s <= radii2[r], rank, torch.full_like(rank, l))
        base = score << QBITS
        outs.append(torch.stack(
            [torch.amin(base + q_t[c][None], dim=1) for c in range(3)]
        ))
    return torch.stack(outs)


def strat_packed_cuda(d2, q_t, off, radii2) -> torch.Tensor:
    """K2 on the card; same contract as :func:`strat_packed_plain`."""
    kq = d2.shape[0]
    _, l, s = q_t.shape
    num_r = radii2.shape[0]
    if not 1 <= num_r <= 4:
        raise ValueError(f"strat kernel takes 1..4 radii, got {num_r}")
    if kq > 65535:
        raise ValueError(f"strat kernel takes at most 65535 centres, got {kq}")
    for t, dt, name in ((d2, torch.float32, "d2"), (q_t, torch.int32, "q"),
                        (off, torch.int32, "off"),
                        (radii2, torch.float32, "radii2")):
        require_cuda(t, dt, f"strat {name}")
    out = torch.empty((num_r, 3, kq, s), dtype=torch.int32, device=d2.device)
    STRAT_KERNEL.launch(ptr(d2), ptr(off), ptr(q_t), ptr(radii2), num_r, kq,
                        l, s, ptr(out))
    return out


def ball_query_stratified_multi(pts, pts_mask, centers, radii, off,
                                nsample: int, d2):
    """Stratified ball query for ALL radii in one pass over ``d2``.

    pts [N, 3], pts_mask [N] (already folded into d2's fill), centers [K, 3],
    radii [R], off [K, S] int32 in [0, N/S), d2 [K, N] masked squared
    distances. Returns (patches [R, K, S, 3], valid [R, K, S]).
    """
    kq, n = d2.shape
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
    if off.shape != (kq, s):
        raise ValueError(f"off must be [{kq}, {s}], got {tuple(off.shape)}")
    q, lo, res = quantize(pts, pts_mask)
    q_t = q.reshape(l, s, 3).permute(2, 0, 1).contiguous()      # [3, L, S]
    radii2 = (radii * radii).to(torch.float32).contiguous()
    off = off.to(torch.int32).contiguous()
    if d2.is_cuda:
        packed = strat_packed_cuda(d2.contiguous(), q_t, off, radii2)
    elif d2.device.type == "cpu":
        packed = strat_packed_plain(d2, q_t, off, radii2)
    else:
        raise ValueError(f"strat: unsupported device {d2.device}")
    return decode(packed, centers, lo, res, l)
