"""Dense moment pooling for the spatial point transformer ("moments" mode).

Counterpart of :mod:`bufferx_tpu.geometry.moments` for the moments-major
serving layout: :func:`pool_cell_moments` pools the ten raw moments of every
in-radius patch point per cylinder cell (kernel K3 on the card, which first
culls by rings of ``azi_n`` cells; its plain version on the CPU), and
:func:`moments_to_features_mm` derotates them by the cell's azimuth and
normalizes them into descriptor-net inputs.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.geometry.cylindrical import grid_cells_on
from benchmark.reference.geometry.spt import NUM_MOMENTS, spt_moments

__all__ = ["NUM_MOMENTS", "pool_cell_moments", "moments_to_features_mm"]


def pool_cell_moments(patches: torch.Tensor, patches_mask: torch.Tensor,
                      rad_n: int, ele_n: int, azi_n: int,
                      delta: float) -> torch.Tensor:
    """Raw per-cell moments [K, 10, G] (moments-major) over ALL in-radius
    points of the normalized (unit-radius) patches [K, P, 3]; the ball
    radius is ``delta / rad_n``."""
    cells = grid_cells_on(rad_n, ele_n, azi_n, patches.device)
    radius = delta / rad_n
    return spt_moments(patches, patches_mask, cells, radius * radius,
                       ring_len=azi_n)


def moments_to_features_mm(raw: torch.Tensor, rad_n: int, ele_n: int,
                           azi_n: int, delta: float) -> torch.Tensor:
    """Derotate + normalize raw moments [K, 10, G] -> features [K, 10, G]:

        [log1p(N)/4, (mean - canon_centre)/cell_r (3), cov/cell_r^2 (6)]

    with the cell at azimuth bin a rotated by R_z(-2 pi a / azi_n) (first
    moments as vectors, second moments as tensors R M R^T) and empty cells
    all-zero."""
    g = rad_n * ele_n * azi_n
    dev = raw.device
    a_idx = torch.arange(g, device=dev) % azi_n
    angles_a = (-2.0 * math.pi / azi_n) * torch.arange(
        azi_n, dtype=raw.dtype, device=dev
    )
    ca = torch.cos(angles_a)[a_idx][None, :]                   # [1, G]
    sa = torch.sin(angles_a)[a_idx][None, :]

    sx, sy, sz = raw[:, 0], raw[:, 1], raw[:, 2]               # [K, G]
    sxx, syy, szz = raw[:, 3], raw[:, 4], raw[:, 5]
    sxy, syz, szx = raw[:, 6], raw[:, 7], raw[:, 8]
    n = raw[:, 9]

    s1x = ca * sx - sa * sy
    s1y = sa * sx + ca * sy
    s1z = sz
    c2, s2, cs = ca * ca, sa * sa, ca * sa
    xx_r = c2 * sxx - 2.0 * cs * sxy + s2 * syy
    yy_r = s2 * sxx + 2.0 * cs * sxy + c2 * syy
    xy_r = cs * (sxx - syy) + (c2 - s2) * sxy
    zx_r = ca * szx - sa * syz
    yz_r = sa * szx + ca * syz
    zz_r = szz

    # canonical cell centres: R_z(angle_a) @ centre, per cell
    centers = grid_cells_on(rad_n, ele_n, azi_n, dev)
    cg, sg = ca[0], sa[0]
    canon_x = cg * centers[:, 0] - sg * centers[:, 1]
    canon_y = sg * centers[:, 0] + cg * centers[:, 1]
    canon_z = centers[:, 2]

    cell_r = delta / rad_n
    n_safe = torch.clamp_min(n, 1.0)
    inv_n = 1.0 / n_safe
    mx, my, mz = s1x * inv_n, s1y * inv_n, s1z * inv_n
    icr = 1.0 / cell_r
    offx = (mx - canon_x[None]) * icr
    offy = (my - canon_y[None]) * icr
    offz = (mz - canon_z[None]) * icr
    icr2 = icr * icr
    inv_ncr2 = inv_n * icr2
    feats = torch.stack(
        [torch.log1p(n) * 0.25,
         offx, offy, offz,
         xx_r * inv_ncr2 - mx * mx * icr2,
         yy_r * inv_ncr2 - my * my * icr2,
         zz_r * inv_ncr2 - mz * mz * icr2,
         xy_r * inv_ncr2 - mx * my * icr2,
         yz_r * inv_ncr2 - my * mz * icr2,
         zx_r * inv_ncr2 - mz * mx * icr2],
        dim=1,
    )                                                          # [K, 10, G]
    return torch.where(n[:, None, :] > 0.0, feats, torch.zeros_like(feats))
