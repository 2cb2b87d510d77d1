"""SPT cell kernels: the cell query (K4) and moment pooling (K3), each
with its plain PyTorch version.

Counterpart of :mod:`bufferx_tpu.geometry.spt_pallas` (same module name).
Both test, per patch and cylinder cell, which valid patch points lie within
``radius`` of the cell centre, with the f32 ``(dx*dx + dy*dy) + dz*dz <=
r^2`` (``d = c - p``) in the kernel and in its plain version, so they agree
on every point.

- K4 (:func:`spt_cell_query`, "sampled" mode): the first ``nsample``
  in-radius points per cell in row order, zero-filled, ``[K, G, ns, 3]``.
  Kernel and plain version agree to the bit.
- K3 (:func:`spt_moments`, "moments" mode): the ten raw moments
  ``[Sx, Sy, Sz, Sxx, Syy, Szz, Sxy, Syz, Szx, N]`` of the in-radius
  points, moments-major ``[K, 10, G]``; counts agree exactly, sums differ
  only by f32 summation order.
"""

from __future__ import annotations

import ctypes

import torch

from bufferx_tpu_torch.cuda_build import CudaKernel, ptr, register, require_cuda

__all__ = ["CELL_QUERY_KERNEL", "MOMENTS_KERNEL", "spt_cell_query_plain",
           "spt_cell_query_cuda", "spt_cell_query", "spt_moments_plain",
           "spt_moments_cuda", "spt_moments"]

NUM_MOMENTS = 10
_V, _I = ctypes.c_void_p, ctypes.c_int
MOMENTS_KERNEL = register(CudaKernel(
    "moments", "moments.cu",
    replaces="bufferx_tpu/geometry/spt_pallas.py:204",
    entry="bx_moments",
    argtypes=[_V, _V, _V, _I, _I, _I, ctypes.c_float, _V],
))
CELL_QUERY_KERNEL = register(CudaKernel(
    "cell_query", "cell_query.cu",
    replaces="bufferx_tpu/geometry/spt_pallas.py:120",
    entry="bx_cell_query",
    argtypes=[_V, _V, _V, _I, _I, _I, _I, ctypes.c_float, _V],
))
_MAX_PATCH_POINTS = 3072       # 13 B of shared memory per point, under 48 KB
_MAX_NSAMPLE = 32              # K4 keeps one slot per lane of a warp


def point_moment_features(patches: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """psi(x) = [x, y, z, xx, yy, zz, xy, yz, zx, 1] per point, zeroed for
    invalid slots: [..., P, 10]."""
    x, y, z = patches[..., 0], patches[..., 1], patches[..., 2]
    psi = torch.stack(
        [x, y, z, x * x, y * y, z * z, x * y, y * z, z * x, torch.ones_like(x)],
        dim=-1,
    )
    return psi * mask[..., None].to(psi.dtype)


def in_radius(patches: torch.Tensor, cells: torch.Tensor,
              radius2: float) -> torch.Tensor:
    """[K, G, P] bool: |c - p|^2 <= r^2 with the kernel's operation order."""
    diff = cells[None, :, None, :] - patches[:, None, :, :]     # [K, G, P, 3]
    dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]
    return ((dx * dx + dy * dy) + dz * dz) <= radius2


def spt_cell_query_plain(patches, mask, cells, radius: float, nsample: int,
                         chunk: int = 64) -> torch.Tensor:
    """Plain version: [K, P, 3], [K, P], [G, 3] -> [K, G, nsample, 3] f32,
    per cell the first ``nsample`` in-radius valid points in row order,
    zero-filled (chunked over patches to bound [chunk, G, P, 3])."""
    p = patches.shape[1]
    # descending priority by row: top-k picks the earliest in-radius rows
    prio = torch.arange(p, 0, -1, device=patches.device)
    outs = []
    for i in range(0, patches.shape[0], chunk):
        pa, ma = patches[i:i + chunk], mask[i:i + chunk]
        ok = in_radius(pa, cells, radius * radius) & ma[:, None, :]
        vals, idx = torch.topk(torch.where(ok, prio, 0), nsample, dim=-1)
        got = torch.gather(
            pa[:, None].expand(-1, cells.shape[0], -1, -1), 2,
            idx[..., None].expand(-1, -1, -1, 3))           # [k, G, ns, 3]
        outs.append(torch.where((vals > 0)[..., None], got, 0.0))
    return torch.cat(outs)


def spt_cell_query_cuda(patches, mask, cells, radius: float,
                        nsample: int) -> torch.Tensor:
    """K4 on the card; same contract as :func:`spt_cell_query_plain`."""
    k, p, _ = patches.shape
    g = cells.shape[0]
    if p > _MAX_PATCH_POINTS:
        raise ValueError(
            f"cell-query kernel takes at most {_MAX_PATCH_POINTS} points per "
            f"patch, got {p}"
        )
    if not 1 <= nsample <= _MAX_NSAMPLE:
        raise ValueError(
            f"cell-query kernel takes 1 <= nsample <= {_MAX_NSAMPLE}, got "
            f"{nsample}"
        )
    patches = patches.contiguous()
    mask_u8 = mask.to(torch.uint8).contiguous()
    cells = cells.contiguous()
    require_cuda(patches, torch.float32, "cell-query patches")
    require_cuda(mask_u8, torch.uint8, "cell-query mask")
    require_cuda(cells, torch.float32, "cell-query cells")
    out = torch.empty((k, g, nsample, 3), dtype=torch.float32,
                      device=patches.device)
    if k:
        CELL_QUERY_KERNEL.launch(ptr(patches), ptr(mask_u8), ptr(cells), k,
                                 p, g, nsample,
                                 ctypes.c_float(radius * radius), ptr(out))
    return out


def spt_cell_query(patches, mask, cells, radius: float,
                   nsample: int) -> torch.Tensor:
    """Dispatch: the plain version for CPU tensors, K4 for CUDA tensors."""
    if patches.is_cuda:
        return spt_cell_query_cuda(patches, mask, cells, radius, nsample)
    if patches.device.type == "cpu":
        return spt_cell_query_plain(patches, mask, cells, radius, nsample)
    raise ValueError(f"spt_cell_query: unsupported device {patches.device}")


def spt_moments_plain(patches, mask, cells, radius2: float,
                      chunk: int = 64) -> torch.Tensor:
    """Plain version: [K, P, 3], [K, P], [G, 3] -> [K, 10, G] f32 (chunked
    over patches to bound the [chunk, G, P, 3] difference tensor)."""
    outs = []
    for i in range(0, patches.shape[0], chunk):
        pa, ma = patches[i:i + chunk], mask[i:i + chunk]
        ok = in_radius(pa, cells, radius2).to(torch.float32)   # [k, G, P]
        psi = point_moment_features(pa, ma)                    # [k, P, 10]
        outs.append(torch.bmm(ok, psi).transpose(1, 2))        # [k, 10, G]
    return torch.cat(outs).contiguous()


def spt_moments_cuda(patches, mask, cells, radius2: float) -> torch.Tensor:
    """K3 on the card; same contract as :func:`spt_moments_plain`."""
    k, p, _ = patches.shape
    g = cells.shape[0]
    if p > _MAX_PATCH_POINTS:
        raise ValueError(
            f"moments kernel takes at most {_MAX_PATCH_POINTS} points per "
            f"patch, got {p}"
        )
    patches = patches.contiguous()
    mask_u8 = mask.to(torch.uint8).contiguous()
    cells = cells.contiguous()
    require_cuda(patches, torch.float32, "moments patches")
    require_cuda(mask_u8, torch.uint8, "moments mask")
    require_cuda(cells, torch.float32, "moments cells")
    out = torch.empty((k, NUM_MOMENTS, g), dtype=torch.float32,
                      device=patches.device)
    MOMENTS_KERNEL.launch(ptr(patches), ptr(mask_u8), ptr(cells), k, p, g,
                          ctypes.c_float(radius2), ptr(out))
    return out


def spt_moments(patches, mask, cells, radius2: float) -> torch.Tensor:
    """Dispatch: the plain version for CPU tensors, K3 for CUDA tensors."""
    if patches.is_cuda:
        return spt_moments_cuda(patches, mask, cells, radius2)
    if patches.device.type == "cpu":
        return spt_moments_plain(patches, mask, cells, radius2)
    raise ValueError(f"spt_moments: unsupported device {patches.device}")
