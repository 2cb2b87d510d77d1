"""Host-side voxel-grid downsampling (the port's own copy).

Counterpart of :func:`bufferx_tpu.kernels.voxel.voxel_downsample_np`, numpy
only: one barycenter per occupied voxel, in voxel-id order. The training
batches are assembled with it on the host before they are shipped to the
card.
"""

from __future__ import annotations

import numpy as np

__all__ = ["voxel_downsample_np"]

_BITS = 21  # 3 * 21 = 63 bits: grids of up to 2M cells a side


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
