"""SPT cell kernels: the cell query (K4) and moment pooling (K3), each
with its plain PyTorch version, and the ring cull both share.

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
  only by f32 summation order (the kernel sums in row order, one owner per
  cell, so it gives the same bits on every run).

**The ring cull.** Only a few percent of the point-cell pairs are hits, so
both kernels first drop most of the pairs with a cheaper test that can never
drop a hit. ``ring_len`` consecutive cells (the azimuth bins of one shell and
one elevation of :func:`~bufferx_tpu_torch.geometry.cylindrical.grid_cell_centers`)
lie on a circle about the z axis, a "ring"; with ``rho = sqrt(x^2 + y^2)``,
``|p - c|^2 >= (rho_p - rho_c)^2 + (z_p - z_c)^2`` whatever the azimuths, so
a point within ``r`` of any cell of the ring passes the 2-D test
``(rho_p - rho_ring)^2 + (z_p - z_ring)^2 <= wide^2``. The ring's values are
taken from the cells given (midrange), and ``wide`` is ``r`` plus the spread
of the ring's cells about those values plus a margin for f32 rounding of
both sides (:func:`ring_params_plain`). The exact test still decides every
hit. :func:`ring_candidates_plain` is the plain twin of the kernels' cull,
the same f32 operations in the same order, so on the card the two keep the
same candidates. The plain versions of K3 and K4 run no cull: they check
``ring_len`` and otherwise ignore it, so they stay the yardstick that the
cull is judged by. Without ``ring_len`` every cell is a ring of one.
"""

from __future__ import annotations

import ctypes
import math

import torch

from bufferx_tpu_torch.cuda_build import CudaKernel, ptr, register, require_cuda

__all__ = ["CELL_QUERY_KERNEL", "MOMENTS_KERNEL", "ring_params_plain",
           "ring_candidates_plain", "ring_candidate_counts_cuda",
           "spt_cell_query_plain", "spt_cell_query_cuda", "spt_cell_query",
           "spt_moments_plain", "spt_moments_cuda", "spt_moments"]

NUM_MOMENTS = 10
_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MOMENTS_KERNEL = register(CudaKernel(
    "moments", "moments.cu",
    replaces="bufferx_tpu/geometry/spt_pallas.py:204",
    entry="bx_moments",
    argtypes=[_V, _V, _V, _I, _I, _I, _I, _F, _F, _V, _V],
))
CELL_QUERY_KERNEL = register(CudaKernel(
    "cell_query", "cell_query.cu",
    replaces="bufferx_tpu/geometry/spt_pallas.py:120",
    entry="bx_cell_query",
    argtypes=[_V, _V, _V, _I, _I, _I, _I, _I, _F, _F, _V],
))
_MAX_PATCH_POINTS = 3072       # 29 B of shared memory per point, before lists
_MAX_NSAMPLE = 32
_SMEM_BUDGET = 227 * 1024 - 16  # kBxSmemMax of csrc/ring_cull.cuh
# the cull's margin: 2^-18 of the magnitudes (64 f32 roundings), and an
# absolute term for underflow; the kernels' header has the same constants
CULL_REL = 2.0 ** -18
CULL_ABS = 1e-18


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


def _no_grad_input(name: str, patches: torch.Tensor) -> None:
    """The kernels read point data only and have no backward: no gradient
    may be asked of their inputs (training passes point data alone)."""
    if patches.requires_grad:
        raise ValueError(f"{name}: the patch points require grad, and the "
                         "cell kernels pass no gradient")


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


def ring_params_plain(cells: torch.Tensor, radius: float, ring_len: int):
    """Per ring of ``ring_len`` consecutive cells [G, 3]: its radius about
    the z axis, its z and the squared widened radius of the cull, each
    [G / ring_len] f32. Every step is one f32 operation, in the order of
    ``bx_ring_params`` (``csrc/ring_cull.cuh``). The exact test squares the
    radius, so its sign does not matter; here its magnitude is taken."""
    c = cells.reshape(-1, ring_len, 3)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    rho = torch.sqrt(cx * cx + cy * cy)
    rmin, rmax = rho.amin(dim=1), rho.amax(dim=1)
    zmin, zmax = cz.amin(dim=1), cz.amax(dim=1)
    rho_r = 0.5 * (rmin + rmax)
    z_r = 0.5 * (zmin + zmax)
    spread = (rmax - rmin) + (zmax - zmin)
    rc = torch.tensor(abs(radius), dtype=torch.float32,
                      device=cells.device) + spread
    mag = (rho_r + z_r.abs()) + rc
    wide = (rc + CULL_REL * mag) + CULL_ABS
    return rho_r, z_r, wide * wide


def ring_candidates_plain(patches, mask, cells, radius: float,
                          ring_len: int) -> torch.Tensor:
    """Plain twin of the kernels' ring cull: [K, G / ring_len, P] bool, the
    valid points of each patch that may lie within ``radius`` of a cell of
    each ring. Never drops a point that :func:`in_radius` accepts."""
    rho_r, z_r, wide2 = ring_params_plain(cells, radius, ring_len)
    x, y, z = patches[..., 0], patches[..., 1], patches[..., 2]
    rho = torch.sqrt(x * x + y * y)                              # [K, P]
    t = rho[:, None, :] - rho_r[None, :, None]
    w = z[:, None, :] - z_r[None, :, None]
    return ((t * t + w * w) <= wide2[None, :, None]) & mask[:, None, :]


def _smem_needed(p: int, g: int, ring_len: int, whole_tile: int,
                 tile_per_ring: int, n_tiles: int) -> int:
    """Bytes of shared memory a block needs at least, with one ring a batch:
    the arithmetic of ``bx_cell_layout`` (``csrc/ring_cull.cuh``), with the
    landing buffer counted whenever P allows bulk copies."""
    def up16(v):
        return (v + 15) // 16 * 16

    n_rings, n_chunks = g // ring_len, (p + 31) // 32
    fixed = (up16(p * 13) if p % 16 == 0 else 0) + (p + 127) // 128 * 128 * 16 \
        + g * 16 + up16(n_rings * 12) + up16(whole_tile)
    per_ring = 4 + p * 2 + n_chunks * ring_len * 4 + n_chunks * 4 \
        + n_tiles * tile_per_ring
    return fixed + 16 * (5 + n_tiles) + per_ring


def _kernel_inputs(name, patches, mask, cells, ring_len, whole_tile=0,
                   tile_per_ring=0, n_tiles=0):
    """Shape guards and the contiguous CUDA tensors the kernels read (the
    bool mask as it is, one byte per point). The last three say what output
    tiles the kernel keeps in shared memory: bytes for all cells, and
    ``n_tiles`` tiles of ``tile_per_ring`` bytes a ring."""
    k, p, _ = patches.shape
    g = cells.shape[0]
    ring_len = _ring_len(g, ring_len)
    if not 1 <= p <= _MAX_PATCH_POINTS:
        raise ValueError(
            f"{name} kernel takes 1 to {_MAX_PATCH_POINTS} points per patch, "
            f"got {p}"
        )
    if g < 1 or mask.shape != (k, p):
        raise ValueError(
            f"{name} kernel expects cells [G >= 1, 3] and mask [K, P], got "
            f"{tuple(cells.shape)} and {tuple(mask.shape)}"
        )
    need = _smem_needed(p, g, ring_len, whole_tile, tile_per_ring, n_tiles)
    if need > _SMEM_BUDGET:
        raise ValueError(
            f"{name} kernel: G = {g} cells in rings of {ring_len} with P = {p} "
            f"points need {need} bytes of shared memory a block, over the "
            f"card's {_SMEM_BUDGET}"
        )
    patches = patches.contiguous()
    cells = cells.contiguous()
    mask = mask.contiguous()
    if mask.dtype != torch.bool:
        mask = mask != 0
    require_cuda(patches, torch.float32, f"{name} patches")
    require_cuda(mask, torch.bool, f"{name} mask")
    require_cuda(cells, torch.float32, f"{name} cells")
    return patches, mask, cells, ring_len


def spt_cell_query_plain(patches, mask, cells, radius: float, nsample: int,
                         chunk: int = 64, *, ring_len=None) -> torch.Tensor:
    """Plain version: [K, P, 3], [K, P], [G, 3] -> [K, G, nsample, 3] f32,
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


def spt_cell_query_cuda(patches, mask, cells, radius: float, nsample: int, *,
                        ring_len=None) -> torch.Tensor:
    """K4 on the card; same contract as :func:`spt_cell_query_plain`."""
    if not 1 <= nsample <= _MAX_NSAMPLE:
        raise ValueError(
            f"cell-query kernel takes 1 <= nsample <= {_MAX_NSAMPLE}, got "
            f"{nsample}"
        )
    # two tiles of a batch's cells alternate between build and store
    patches, mask, cells, ring_len = _kernel_inputs(
        "cell-query", patches, mask, cells, ring_len,
        tile_per_ring=(ring_len or 1) * 3 * nsample * 4, n_tiles=2)
    k, p, _ = patches.shape
    g = cells.shape[0]
    out = torch.empty((k, g, nsample, 3), dtype=torch.float32,
                      device=patches.device)
    if k:
        CELL_QUERY_KERNEL.launch(ptr(patches), ptr(mask), ptr(cells), k, p, g,
                                 ring_len, nsample, _F(abs(radius)),
                                 _F(radius * radius), ptr(out))
    return out


def spt_cell_query(patches, mask, cells, radius: float, nsample: int, *,
                   ring_len=None) -> torch.Tensor:
    """Dispatch: the plain version for CPU tensors, K4 for CUDA tensors.
    ``ring_len``: the number of consecutive cells that share a ring about
    the z axis (the grid's ``azi_n``)."""
    _no_grad_input("spt_cell_query", patches)
    if patches.is_cuda:
        return spt_cell_query_cuda(patches, mask, cells, radius, nsample,
                                   ring_len=ring_len)
    if patches.device.type == "cpu":
        return spt_cell_query_plain(patches, mask, cells, radius, nsample,
                                    ring_len=ring_len)
    raise ValueError(f"spt_cell_query: unsupported device {patches.device}")


def spt_moments_plain(patches, mask, cells, radius2: float,
                      chunk: int = 64, *, ring_len=None) -> torch.Tensor:
    """Plain version: [K, P, 3], [K, P], [G, 3] -> [K, 10, G] f32 (chunked
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


def _launch_moments(patches, mask, cells, radius: float, radius2: float,
                    ring_len, want_counts: bool):
    patches, mask, cells, ring_len = _kernel_inputs(
        "moments", patches, mask, cells, ring_len,
        whole_tile=NUM_MOMENTS * cells.shape[0] * 4)
    k, p, _ = patches.shape
    g = cells.shape[0]
    out = torch.empty((k, NUM_MOMENTS, g), dtype=torch.float32,
                      device=patches.device)
    counts = torch.empty((k, g // ring_len), dtype=torch.int32,
                         device=patches.device) if want_counts else None
    if k:
        MOMENTS_KERNEL.launch(ptr(patches), ptr(mask), ptr(cells), k, p, g,
                              ring_len, _F(radius), _F(radius2), ptr(out),
                              ptr(counts) if want_counts else None)
    return out, counts


def spt_moments_cuda(patches, mask, cells, radius2: float, *,
                     ring_len=None) -> torch.Tensor:
    """K3 on the card; same contract as :func:`spt_moments_plain`."""
    return _launch_moments(patches, mask, cells, math.sqrt(radius2), radius2,
                           ring_len, False)[0]


def ring_candidate_counts_cuda(patches, mask, cells, radius: float,
                               ring_len: int) -> torch.Tensor:
    """The kernels' ring cull on the card: the number of candidates of every
    ring, [K, G / ring_len] int32, as a K3 launch writes them on request (to
    be held against ``ring_candidates_plain(...).sum(-1)``)."""
    return _launch_moments(patches, mask, cells, abs(radius), radius * radius,
                           ring_len, True)[1]


def spt_moments(patches, mask, cells, radius2: float, *,
                ring_len=None) -> torch.Tensor:
    """Dispatch: the plain version for CPU tensors, K3 for CUDA tensors.
    ``ring_len``: the number of consecutive cells that share a ring about
    the z axis (the grid's ``azi_n``)."""
    _no_grad_input("spt_moments", patches)
    if patches.is_cuda:
        return spt_moments_cuda(patches, mask, cells, radius2,
                                ring_len=ring_len)
    if patches.device.type == "cpu":
        return spt_moments_plain(patches, mask, cells, radius2,
                                 ring_len=ring_len)
    raise ValueError(f"spt_moments: unsupported device {patches.device}")
