"""Cylindrical grid geometry (the port's own copy of the grid centres).

Counterpart of :func:`bufferx_tpu.geometry.cylindrical.grid_cell_centers`.
Cells are indexed ``[rad, ele, azi]`` and flattened C-order to
``G = rad_n * ele_n * azi_n``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["grid_cell_centers"]


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
