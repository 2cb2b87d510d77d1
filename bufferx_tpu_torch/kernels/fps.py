"""Farthest point sampling: CUDA kernel K1 and its plain PyTorch version.

Counterpart of :mod:`bufferx_tpu.kernels.fps`. Both versions take a batch of
clouds ``xyz [B, N, 3]`` with validity ``mask [B, N]``: padded slots start
the running min-distance field at -1 (they never win the argmax), valid ones
at +inf (the first pick is the first valid index), and each round takes the
argmax with ties to the lowest index. The squared distance is
``(dx*dx + dy*dy) + dz*dz`` in that order in both, so the indices agree
exactly. :func:`fps` finalizes like the JAX package: indices past the number
of valid points repeat the first pick, and ``valid_out`` marks the real ones.
"""

from __future__ import annotations

import ctypes

import torch

from bufferx_tpu_torch.cuda_build import CudaKernel, ptr, register, require_cuda

__all__ = [
    "FPS_KERNEL",
    "farthest_point_sampling_plain",
    "farthest_point_sampling_cuda",
    "fps_exchange_floor_cuda",
    "fps",
]

_V, _I = ctypes.c_void_p, ctypes.c_int
FPS_KERNEL = register(CudaKernel(
    "fps", "fps.cu", replaces="bufferx_tpu/kernels/fps.py:87",
    entry="bx_fps", argtypes=[_V, _V, _I, _I, _I, _V, _I],
))
# a cluster of 8 blocks x 256 threads x 16 register slots per thread
_MAX_POINTS = 32 * 1024


def _sqdist3(diff: torch.Tensor) -> torch.Tensor:
    """(dx*dx + dy*dy) + dz*dz over the last axis, each op rounded alone."""
    dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def farthest_point_sampling_plain(xyz: torch.Tensor, mask: torch.Tensor,
                                  num_samples: int) -> torch.Tensor:
    """Raw FPS indices [B, num_samples] int32 (before finalizing)."""
    b = xyz.shape[0]
    mind = torch.where(
        mask, torch.full_like(xyz[..., 0], float("inf")),
        torch.full_like(xyz[..., 0], -1.0),
    )
    rows = torch.arange(b, device=xyz.device)
    out = torch.empty((b, num_samples), dtype=torch.int32, device=xyz.device)
    for i in range(num_samples):
        sel = torch.argmax(mind, dim=1)                       # [B]
        out[:, i] = sel.to(torch.int32)
        d = _sqdist3(xyz - xyz[rows, sel][:, None, :])
        mind = torch.minimum(mind, d)
    return out


def farthest_point_sampling_cuda(xyz: torch.Tensor, mask: torch.Tensor,
                                 num_samples: int) -> torch.Tensor:
    """K1 on the card: raw FPS indices [B, num_samples] int32. The kernel
    reads ``xyz [B, N, 3]`` and the bool mask as they are (no copies)."""
    return _launch(xyz, mask, num_samples, exchange_only=False)


def fps_exchange_floor_cuda(xyz: torch.Tensor, mask: torch.Tensor,
                            num_samples: int) -> None:
    """K1's rounds with the slot exchange between the cluster's blocks and
    its waits alone (no field update, no argmax): the time of this launch is
    the latency floor of the kernel's design at these shapes."""
    _launch(xyz, mask, num_samples, exchange_only=True)


def _launch(xyz, mask, num_samples, exchange_only):
    b, n, _ = xyz.shape
    if not 1 <= n <= _MAX_POINTS:
        raise ValueError(f"fps kernel takes 1 to {_MAX_POINTS} points, got {n}")
    xyz = xyz.contiguous()
    mask = mask.contiguous()
    require_cuda(xyz, torch.float32, "fps xyz")
    require_cuda(mask, torch.bool, "fps mask")
    out = torch.empty((b, num_samples), dtype=torch.int32, device=xyz.device)
    if b and num_samples:
        FPS_KERNEL.launch(ptr(xyz), ptr(mask), b, n, num_samples, ptr(out),
                          int(exchange_only))
    return out


def fps(xyz: torch.Tensor, mask: torch.Tensor, num_samples: int):
    """Masked FPS for a batch: returns (idx [B, K] int64, valid_out [B, K]).

    CPU tensors take the plain version; CUDA tensors the kernel."""
    if xyz.ndim != 3 or xyz.shape[-1] != 3 or mask.shape != xyz.shape[:2]:
        raise ValueError(f"fps expects xyz [B, N, 3] and mask [B, N], got "
                         f"{tuple(xyz.shape)} and {tuple(mask.shape)}")
    if xyz.is_cuda:
        idx = farthest_point_sampling_cuda(xyz, mask, num_samples)
    elif xyz.device.type == "cpu":
        idx = farthest_point_sampling_plain(xyz, mask, num_samples)
    else:
        raise ValueError(f"fps: unsupported device {xyz.device}")
    idx = idx.long()
    num_valid = mask.sum(dim=1, keepdim=True)
    valid_out = torch.arange(num_samples, device=xyz.device)[None] < num_valid
    idx = torch.where(valid_out, idx, idx[:, :1])
    return idx, valid_out
