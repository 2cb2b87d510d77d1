"""Cylindrical grid geometry: grid centres and the spatial point transformer.

Counterpart of :mod:`bufferx_tpu.geometry.cylindrical`. Cells are indexed
``[rad, ele, azi]`` and flattened C-order to ``G = rad_n * ele_n * azi_n``.
:func:`spatial_point_transformer` is the reference "sampled" descriptor's
input: per cell, the first ``nsample`` in-radius points of each patch in row
order (kernel K4 on the card, its plain version on the CPU), derotated per
azimuth column by :func:`var_to_invar`. The ``azi_n`` cells of one shell and
one elevation are consecutive and lie on a circle about the z axis: K4 and
K3 are told so (``ring_len=azi_n``) and cull by ring before the exact test.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from benchmark.reference.core.se3 import rotation_z
from benchmark.reference.geometry.spt import spt_cell_query

__all__ = ["grid_cell_centers", "grid_cells_on", "spatial_point_transformer",
           "var_to_invar"]


def grid_cell_centers(rad_n: int, ele_n: int, azi_n: int) -> np.ndarray:
    """Cell centres of the unit cylindrical(-spherical) grid, [G, 3] f32:
    rings of ``azi_n`` azimuth bins at ``ele_n`` elevations, at ``rad_n``
    radial shells of radii (i + 0.5) / rad_n."""
    beta = np.linspace(0.0, np.pi, ele_n, endpoint=False) + np.pi / ele_n / 2.0
    alpha = np.linspace(0.0, 2.0 * np.pi, azi_n, endpoint=False) + np.pi / azi_n
    B, A = np.meshgrid(beta, alpha, indexing="ij")      # [ele, azi]
    st, ct = np.sin(B), np.cos(B)
    cp, sp = np.cos(A), np.sin(A)
    on_sphere = np.stack([st * cp, st * sp, ct], axis=-1).reshape(-1, 3)
    shells = (np.arange(rad_n) / rad_n + 1.0 / (2 * rad_n)).reshape(rad_n, 1, 1)
    return (shells * on_sphere[None]).reshape(-1, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _grid_cells_on(rad_n: int, ele_n: int, azi_n: int,
                   device: torch.device) -> torch.Tensor:
    return torch.as_tensor(grid_cell_centers(rad_n, ele_n, azi_n),
                           device=device)


def grid_cells_on(rad_n: int, ele_n: int, azi_n: int, device) -> torch.Tensor:
    """:func:`grid_cell_centers` as a tensor on ``device``, copied there once
    and kept (a host-to-device copy waits for the stream's queued work). Do
    not write to the result."""
    return _grid_cells_on(rad_n, ele_n, azi_n, torch.device(device))


def spatial_point_transformer(patches: torch.Tensor, patches_mask: torch.Tensor,
                              rad_n: int, ele_n: int, azi_n: int,
                              delta: float, nsample: int) -> torch.Tensor:
    """SPT: the first ``nsample`` valid points of each normalized patch
    [K, P, 3] within ``delta / rad_n`` of each cell centre, in row order
    (rows arrive shuffled, so this is a uniform random subset), zero-filled,
    then derotated: [K, G, nsample, 3]."""
    cells = grid_cells_on(rad_n, ele_n, azi_n, patches.device)
    out = spt_cell_query(patches, patches_mask, cells, delta / rad_n, nsample,
                         ring_len=azi_n)
    return var_to_invar(out, rad_n, ele_n, azi_n)


def var_to_invar(pts: torch.Tensor, rad_n: int, ele_n: int,
                 azi_n: int) -> torch.Tensor:
    """Rotate the points of the cells at azimuth bin ``a`` by
    R_z(-a * 2 pi / azi_n), so every column shares one frame.
    pts [K, G, ns, 3] -> [K, G, ns, 3]."""
    k, g, ns, _ = pts.shape
    angles = (-2.0 * math.pi / azi_n) * torch.arange(
        azi_n, dtype=pts.dtype, device=pts.device)
    R = rotation_z(angles)                                     # [azi, 3, 3]
    out = torch.einsum("kreasd,acd->kreasc",
                       pts.reshape(k, rad_n, ele_n, azi_n, ns, 3), R)
    return out.reshape(k, g, ns, 3)
