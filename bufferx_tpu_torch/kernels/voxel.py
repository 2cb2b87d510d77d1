"""Voxel-grid downsampling (barycenter per occupied voxel).

Counterpart of :mod:`bufferx_tpu.kernels.voxel`, two implementations with
one meaning:

- :func:`voxel_downsample`: on the device, static capacity. Points are
  sorted by voxel, segment starts marked, and the points scatter-added into
  a fixed-capacity output with one overflow row for what does not fit;
  torch ops, with an optional leading cloud dimension. Output order is
  voxel order (lexicographic in the cell's x, y, z).
- :func:`voxel_downsample_np`: host-side numpy for ragged clouds. The
  loaders and the training batches use this one, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["voxel_downsample", "voxel_downsample_np"]

_BITS = 21  # 3 * 21 = 63 bits: grids of up to 2M cells a side
_BIG = 1 << 30  # the cell of a padded point, on every axis: it sorts last


def voxel_downsample(xyz: torch.Tensor, mask: torch.Tensor, voxel_size,
                     capacity: int):
    """Barycenter voxel downsample with a fixed output capacity.

    xyz [(C,) N, 3], mask [(C,) N], voxel_size a number or 0-d tensor.
    Returns (out_xyz [(C,) capacity, 3], out_mask [(C,) capacity]). When
    more than ``capacity`` voxels are occupied, the excess (the last in
    voxel order) goes to the overflow row and is dropped."""
    single = xyz.ndim == 2
    if single:
        xyz, mask = xyz[None], mask[None]
    c = xyz.shape[0]
    origin = torch.where(mask[..., None], xyz, float("inf")).amin(
        dim=1, keepdim=True)
    cell = torch.floor((xyz - origin) / voxel_size).to(torch.int32)
    cell = torch.where(mask[..., None], cell.clamp(0, _BIG - 1), _BIG)

    # lexicographic order by (x, y, z): a stable sort on z, then on x and y
    # packed into one int64 (each axis fits in 31 bits)
    cell64 = cell.to(torch.int64)
    order = torch.sort(cell64[..., 2], dim=1, stable=True).indices
    xy = (cell64[..., 0] << 31) | cell64[..., 1]
    order = torch.gather(
        order, 1,
        torch.sort(torch.gather(xy, 1, order), dim=1, stable=True).indices)
    cell_s = torch.gather(cell, 1, order[..., None].expand(-1, -1, 3))
    xyz_s = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    mask_s = torch.gather(mask, 1, order)

    changed = torch.any(cell_s[:, 1:] != cell_s[:, :-1], dim=-1)
    new_seg = torch.cat([torch.ones_like(changed[:, :1]), changed], dim=1) \
        & mask_s
    seg_idx = torch.cumsum(new_seg.to(torch.int32), dim=1) - 1
    in_cap = mask_s & (seg_idx < capacity) & (seg_idx >= 0)
    tgt = torch.where(in_cap, seg_idx, capacity).to(torch.int64)  # overflow

    sums = torch.zeros(c, capacity + 1, 3, dtype=xyz.dtype, device=xyz.device)
    sums.scatter_add_(1, tgt[..., None].expand(-1, -1, 3),
                      torch.where(in_cap[..., None], xyz_s, 0.0))
    cnts = torch.zeros(c, capacity + 1, dtype=torch.int32, device=xyz.device)
    cnts.scatter_add_(1, tgt, in_cap.to(torch.int32))
    sums, cnts = sums[:, :capacity], cnts[:, :capacity]
    out_mask = cnts > 0
    out_xyz = sums / torch.clamp_min(cnts, 1)[..., None]
    return (out_xyz[0], out_mask[0]) if single else (out_xyz, out_mask)


def voxel_downsample_np(xyz: np.ndarray, voxel_size: float) -> np.ndarray:
    """Barycenter voxel downsample, ragged [N, 3] in, ragged [M, 3] out."""
    if len(xyz) == 0:
        return xyz
    cell = np.floor((xyz - xyz.min(axis=0)) / voxel_size).astype(np.int64)
    vid = (cell[:, 0] << (2 * _BITS)) | (cell[:, 1] << _BITS) | cell[:, 2]
    uniq, inv, cnt = np.unique(vid, return_inverse=True, return_counts=True)
    sums = np.zeros((len(uniq), 3), xyz.dtype)
    np.add.at(sums, inv, xyz)
    return sums / cnt[:, None]
