"""Rigid hypotheses scored against correspondences: CUDA kernel K6 and its
plain PyTorch version.

RANSAC (:func:`bufferx_tpu_torch.solver.ransac.ransac_pose`) and the
cross-scale consensus (:func:`bufferx_tpu_torch.solver.consensus.
cross_scale_consensus`) both count, for every hypothesis ``(R, t)`` of a
pair, the masked correspondences ``(s, g)`` with ``||R s + t - g|| < thr``,
and give -1 to the hypotheses their gate rejects; ``torch.argmax`` over the
counts then picks the winner (ties to the lowest index). The threshold is
one number (RANSAC's ``dist_th``) or one a correspondence (the consensus's
``[B, C]``).

:func:`hyp_score_plain` is the eager chunk loop the two solvers ran inline:
a chunk of hypotheses at a time, warped points through ``einsum``, then
``+ t``, ``- g``, the norm, the compare, the mask and the sum. The kernel
(``csrc/hyp_score.cu``) keeps the warped points in registers and rounds
where that chain rounds, so its counts equal the chain's on the card. It
replaces no Pallas kernel: the JAX package scores in jnp.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bufferx_tpu_torch.cuda_build import CudaKernel, ptr, register, require_cuda

__all__ = ["HYP_SCORE_KERNEL", "hyp_score_plain", "hyp_score_cuda",
           "hyp_score", "split_count"]

_V, _I = ctypes.c_void_p, ctypes.c_int
HYP_SCORE_KERNEL = register(CudaKernel(
    "hyp_score", "hyp_score.cu", replaces=None, entry="bx_hyp_score",
    argtypes=[_V] * 9 + [ctypes.c_float, _I, _I, _I, _I],
))
# hypotheses a block (csrc/hyp_score.cu: kHypTile); correspondences a split
# at least; blocks a multiprocessor the split aims for
_HYP_TILE = 256
_MIN_SPLIT = 256
_BLOCKS_PER_SM = 8


def hyp_score_plain(R, t, src, tgt, thr, mask, gate,
                    chunk: int) -> torch.Tensor:
    """The eager chunk loop: R [B, H, 3, 3], t [B, H, 3], src/tgt
    [B, C, 3], thr a float or [B, C], mask [B, C] and gate [B, H] bool ->
    counts [B, H] int64 (-1 where ``gate`` is False). Any device."""
    thr = thr[:, None] if isinstance(thr, torch.Tensor) else thr
    counts = []
    for i in range(0, R.shape[1], chunk):
        warped = (torch.einsum("bhij,bcj->bhci", R[:, i:i + chunk], src)
                  + t[:, i:i + chunk, None, :])
        d = torch.linalg.norm(warped - tgt[:, None], dim=-1)
        n_in = torch.sum((d < thr) & mask[:, None], dim=-1)
        counts.append(torch.where(gate[:, i:i + chunk], n_in,
                                  torch.full_like(n_in, -1)))
    return torch.cat(counts, dim=1)


def split_count(b: int, h: int, c: int, sms: int) -> int:
    """How many parts the kernel cuts C into: enough blocks for
    ``_BLOCKS_PER_SM`` a multiprocessor where pairs x hypothesis tiles fall
    short, with at least ``_MIN_SPLIT`` correspondences a part."""
    blocks = b * -(-h // _HYP_TILE)
    if blocks == 0 or c <= _MIN_SPLIT:
        return 1
    want = -(-(_BLOCKS_PER_SM * sms) // blocks)
    return max(1, min(want, c // _MIN_SPLIT))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(R, t, src, tgt, thr, mask, gate) -> tuple:
    """(B, H, C) of a valid call; raises on any other shapes."""
    if R.ndim != 4 or R.shape[2:] != (3, 3):
        raise ValueError(f"hyp_score: R must be [B, H, 3, 3], got "
                         f"{tuple(R.shape)}")
    b, h = R.shape[:2]
    if src.ndim != 3 or src.shape[0] != b or src.shape[2] != 3:
        raise ValueError(f"hyp_score: src must be [{b}, C, 3], got "
                         f"{tuple(src.shape)}")
    c = src.shape[1]
    for name, x, shape in (("t", t, (b, h, 3)), ("tgt", tgt, (b, c, 3)),
                           ("mask", mask, (b, c)), ("gate", gate, (b, h))):
        if tuple(x.shape) != shape:
            raise ValueError(f"hyp_score: {name} must be {list(shape)}, got "
                             f"{tuple(x.shape)}")
    if isinstance(thr, torch.Tensor) and tuple(thr.shape) != (b, c):
        raise ValueError(f"hyp_score: a threshold tensor must be [{b}, {c}], "
                         f"got {tuple(thr.shape)}")
    return b, h, c


def hyp_score_cuda(R, t, src, tgt, thr, mask, gate,
                   dist: torch.Tensor | None = None) -> torch.Tensor:
    """K6 on the card: the counts of :func:`hyp_score_plain` (float32 and
    bool CUDA tensors; ``thr`` a float or a float32 [B, C]). ``dist``, a
    float32 [B, H, C], receives every scored distance (a probe of the
    kernel's rounding; correspondences the mask drops and hypotheses the
    gate drops are not written). Raises on another dtype, shape or device."""
    b, h, c = _check(R, t, src, tgt, thr, mask, gate)
    per_thr = isinstance(thr, torch.Tensor)
    R, t, src, tgt, mask, gate = (x.contiguous() for x in
                                  (R, t, src, tgt, mask, gate))
    for x, dtype, name in ((R, torch.float32, "R"), (t, torch.float32, "t"),
                           (src, torch.float32, "src"),
                           (tgt, torch.float32, "tgt"),
                           (mask, torch.bool, "mask"),
                           (gate, torch.bool, "gate")):
        require_cuda(x, dtype, f"hyp_score {name}")
    if per_thr:
        thr = thr.contiguous()
        require_cuda(thr, torch.float32, "hyp_score thr")
    if dist is not None:
        require_cuda(dist, torch.float32, "hyp_score dist")
        if tuple(dist.shape) != (b, h, c):
            raise ValueError(f"hyp_score: dist must be [{b}, {h}, {c}], got "
                             f"{tuple(dist.shape)}")
    devices = {x.device for x in (R, t, src, tgt, mask, gate)}
    if per_thr:
        devices.add(thr.device)
    if len(devices) != 1:
        raise ValueError(f"hyp_score: tensors on several devices {devices}")
    counts = torch.empty((b, h), dtype=torch.int64, device=R.device)
    if b == 0 or h == 0:
        return counts
    splits = split_count(b, h, c, _sm_count(R.device.index))
    none = ctypes.c_void_p(0)
    HYP_SCORE_KERNEL.launch(
        ptr(R), ptr(t), ptr(src), ptr(tgt), ptr(thr) if per_thr else none,
        ptr(mask), ptr(gate), ptr(counts),
        ptr(dist) if dist is not None else none,
        ctypes.c_float(0.0 if per_thr else float(thr)), b, h, c, splits)
    return counts


def hyp_score(R, t, src, tgt, thr, mask, gate, chunk: int) -> torch.Tensor:
    """Dispatch: the kernel for CUDA tensors, the plain version (chunks of
    ``chunk`` hypotheses) for CPU tensors."""
    if R.is_cuda:
        return hyp_score_cuda(R, t, src, tgt, thr, mask, gate)
    if R.device.type == "cpu":
        return hyp_score_plain(R, t, src, tgt, thr, mask, gate, chunk)
    raise ValueError(f"hyp_score: unsupported device {R.device}")
