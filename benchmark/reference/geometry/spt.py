"""SPT cell moments and the cell query, plain PyTorch (frozen copy).

The plain versions of the port's cell kernels (K3 moments, K4 cell query),
copied so that the benchmark's reference imports nothing of the program.
They run on any device; there is no kernel here.
"""

from __future__ import annotations

import torch

__all__ = ["NUM_MOMENTS", "point_moment_features", "in_radius",
           "spt_cell_query", "spt_moments"]

NUM_MOMENTS = 10


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


def _ring_len(num_cells: int, ring_len) -> int:
    """The ring length to use: 1 (every cell its own ring) when not given."""
    if ring_len is None:
        return 1
    if ring_len < 1 or num_cells % ring_len:
        raise ValueError(
            f"the number of cells ({num_cells}) is not a multiple of the ring "
            f"length ({ring_len})"
        )
    return int(ring_len)


def spt_cell_query(patches, mask, cells, radius: float, nsample: int,
                   chunk: int = 64, *, ring_len=None) -> torch.Tensor:
    """[K, P, 3], [K, P], [G, 3] -> [K, G, nsample, 3] f32,
    per cell the first ``nsample`` in-radius valid points in row order,
    zero-filled (chunked over patches to bound [chunk, G, P, 3]).
    ``ring_len`` is checked and not used: no cull here."""
    p = patches.shape[1]
    _ring_len(cells.shape[0], ring_len)
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


def spt_moments(patches, mask, cells, radius2: float,
                chunk: int = 64, *, ring_len=None) -> torch.Tensor:
    """[K, P, 3], [K, P], [G, 3] -> [K, 10, G] f32 (chunked
    over patches to bound the [chunk, G, P, 3] difference tensor).
    ``ring_len`` is checked and not used: no cull here."""
    _ring_len(cells.shape[0], ring_len)
    outs = []
    for i in range(0, patches.shape[0], chunk):
        pa, ma = patches[i:i + chunk], mask[i:i + chunk]
        ok = in_radius(pa, cells, radius2) & ma[:, None, :]    # [k, G, P]
        psi = point_moment_features(pa, ma)                    # [k, P, 10]
        outs.append(torch.bmm(ok.to(torch.float32), psi).transpose(1, 2))
    return torch.cat(outs).contiguous()                        # [K, 10, G]
