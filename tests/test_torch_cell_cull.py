"""The ring cull shared by the SPT cell kernels K3 and K4: its plain twin
(:func:`ring_candidates_plain`) never drops a hit.

For every (patch, cell, point) that the exact f32 test ``in_radius`` accepts
on a valid point, the point must be a candidate of the cell's ring: tolerance
0, on seeded patches (uniform ball, a plane through the origin, a cluster
inside one cell), on adversarial points at distance r and one ulp either
side of it from cell centres, on and next to the z axis, at scales where the
margin's relative and absolute terms each decide, and on hypothesis-drawn
f32 points. The cull must also cull: on a uniform ball it keeps under a
quarter of the pairs of the 3x7x20 grid (measured 11%).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from bufferx_tpu_torch.geometry.cylindrical import grid_cell_centers
from bufferx_tpu_torch.geometry.spt_pallas import (
    in_radius,
    ring_candidates_plain,
    ring_params_plain,
    spt_cell_query_cuda,
    spt_cell_query_plain,
    spt_moments_cuda,
    spt_moments_plain,
)

GRIDS = [(3, 7, 20), (2, 3, 5), (1, 1, 1)]
DELTA = 0.8


def _dropped(patches, mask, cells, radius, ring_len):
    """(hits the cull drops, hits, candidate pairs, all pairs)."""
    patches = torch.from_numpy(np.ascontiguousarray(patches, np.float32))
    mask = torch.from_numpy(mask)
    cells = torch.from_numpy(np.ascontiguousarray(cells, np.float32))
    hit = in_radius(patches, cells, radius * radius) & mask[:, None, :]
    cand = ring_candidates_plain(patches, mask, cells, radius, ring_len)
    cand = cand.repeat_interleave(ring_len, dim=1)
    return (int((hit & ~cand).sum()), int(hit.sum()), int(cand.sum()),
            hit.numel())


def _ball(rs, k, p):
    v = rs.randn(k, p, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v * rs.uniform(0, 1, (k, p, 1)) ** (1 / 3)


def _plane(rs, k, p):
    """Points of a random plane through the origin, within the unit ball."""
    n = rs.randn(k, 1, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pts = _ball(rs, k, p)
    return pts - (pts * n).sum(-1, keepdims=True) * n


def _cluster(rs, k, p, cells, radius):
    """Every point inside one cell's ball (a different cell per patch)."""
    centre = cells[rs.randint(0, len(cells), k)][:, None, :]
    return centre + _ball(rs, k, p) * radius * 0.9


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("kind", ["ball", "plane", "cluster"])
def test_cull_keeps_every_hit_on_seeded_patches(grid, kind):
    rad_n, ele_n, azi_n = grid
    cells = grid_cell_centers(*grid)
    radius = DELTA / rad_n
    rs = np.random.RandomState(10 * GRIDS.index(grid) + len(kind))
    k, p = 6, 256
    pts = {"ball": lambda: _ball(rs, k, p), "plane": lambda: _plane(rs, k, p),
           "cluster": lambda: _cluster(rs, k, p, cells, radius)}[kind]()
    mask = rs.uniform(size=(k, p)) < 0.9
    dropped, hits, _, _ = _dropped(pts, mask, cells, radius, azi_n)
    assert hits > 0 and dropped == 0
    # every cell a ring of one: the cull is a torus about each cell
    assert _dropped(pts, mask, cells, radius, 1)[0] == 0


def _boundary_points(cells, radius, scale=1.0):
    """Points at distance r, nextafter(r, 0) and nextafter(r, inf) (f32) from
    every cell centre, along the axes, the cell's radial and tangential
    directions and seeded random ones, rounded to f32, plus their
    neighbours one ulp away in each coordinate."""
    rs = np.random.RandomState(5)
    c = cells.astype(np.float64) * scale
    rho = np.linalg.norm(c[:, :2], axis=1, keepdims=True)
    radial = np.where(rho > 0, c * [1, 1, 0] / np.maximum(rho, 1e-30),
                      [1.0, 0, 0])
    tangent = radial[:, [1, 0, 2]] * [-1, 1, 0]
    dirs = [np.broadcast_to(np.array(a, float), c.shape) for a in
            ([1, 0, 0], [0, 1, 0], [0, 0, 1])] + [radial, tangent]
    for _ in range(4):
        d = rs.randn(*c.shape)
        dirs.append(d / np.linalg.norm(d, axis=1, keepdims=True))
    r32 = np.float32(radius * scale)
    dists = [r32, np.nextafter(r32, np.float32(0)),
             np.nextafter(r32, np.float32(np.inf))]
    pts = [c + s * float(d) * u for u in dirs for d in dists for s in (1, -1)]
    pts = np.concatenate(pts).astype(np.float32)
    nudged = [pts]
    for axis in range(3):
        for to in (-np.inf, np.inf):
            q = pts.copy()
            q[:, axis] = np.nextafter(q[:, axis], np.float32(to))
            nudged.append(q)
    return np.concatenate(nudged)[None]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("scale", [1.0, 1e3, 1e-3, 1e-12])
def test_cull_keeps_every_hit_at_the_boundary(grid, scale):
    rad_n, _, azi_n = grid
    cells = grid_cell_centers(*grid)
    radius = DELTA / rad_n
    pts = _boundary_points(cells, radius, scale)
    mask = np.ones(pts.shape[:2], bool)
    cells_s = (cells.astype(np.float64) * scale).astype(np.float32)
    total = 0
    for i in range(0, pts.shape[1], 8192):      # bound [G, 8192] temporaries
        dropped, hits, _, _ = _dropped(pts[:, i:i + 8192], mask[:, i:i + 8192],
                                       cells_s, float(np.float32(radius * scale)),
                                       azi_n)
        assert dropped == 0
        total += hits
    assert total > 0


def test_cull_keeps_points_on_the_z_axis():
    """rho = 0: the ring's far side is as near as its near side."""
    cells = grid_cell_centers(3, 7, 20)
    radius = DELTA / 3
    z = np.linspace(-1, 1, 2001, dtype=np.float32)
    tiny = np.float32(1e-30)
    pts = np.concatenate([
        np.stack([np.zeros_like(z), np.zeros_like(z), z], -1),
        np.stack([np.full_like(z, tiny), np.zeros_like(z), z], -1),
        np.stack([np.zeros_like(z), np.full_like(z, -1e-7), z], -1),
    ])[None]
    mask = np.ones(pts.shape[:2], bool)
    dropped, hits, _, _ = _dropped(pts, mask, cells, radius, 20)
    assert hits > 0 and dropped == 0
    # cells on the axis themselves (ring radius 0)
    axis_cells = np.array([[0, 0, 0.5], [0, 0, -0.25]], np.float32)
    for ring_len in (1, 2):
        assert _dropped(pts, mask, axis_cells, 0.3, ring_len)[0] == 0


def test_cull_widens_by_the_spread_of_a_ragged_ring():
    """Cells passed in need not lie on a perfect circle: a ring's cells may
    differ in rho and z, and the cull widens by their spread."""
    rs = np.random.RandomState(9)
    cells = grid_cell_centers(2, 3, 5)
    cells = cells + rs.uniform(-0.05, 0.05, cells.shape).astype(np.float32)
    pts = _ball(rs, 4, 512)
    mask = np.ones(pts.shape[:2], bool)
    for ring_len in (5, 15, 30):
        dropped, hits, _, _ = _dropped(pts, mask, cells, 0.4, ring_len)
        assert hits > 0 and dropped == 0


def test_cull_share_and_masked_points():
    rs = np.random.RandomState(1)
    cells = grid_cell_centers(3, 7, 20)
    pts = _ball(rs, 8, 512)
    mask = rs.uniform(size=(8, 512)) < 0.9
    dropped, hits, cands, pairs = _dropped(pts, mask, cells, DELTA / 3, 20)
    assert dropped == 0
    assert hits / pairs < cands / pairs < 0.25
    cand = ring_candidates_plain(torch.from_numpy(pts.astype(np.float32)),
                                 torch.from_numpy(mask),
                                 torch.from_numpy(cells), DELTA / 3, 20)
    assert cand.shape == (8, 21, 512)
    assert not bool(cand[~torch.from_numpy(mask)[:, None, :].expand_as(cand)]
                    .any())                 # masked points enter no list
    rho_r, z_r, wide2 = ring_params_plain(torch.from_numpy(cells), DELTA / 3,
                                          20)
    assert rho_r.shape == z_r.shape == wide2.shape == (21,)
    assert bool((wide2 > (DELTA / 3) ** 2).all())
    assert float(wide2.max()) < (DELTA / 3 * 1.001) ** 2


_f32 = st.floats(-1.0, 1.0, width=32, allow_nan=False)


@settings(max_examples=60, deadline=None)
@given(hnp.arrays(np.float32, (1, 64, 3), elements=_f32),
       st.sampled_from(GRIDS),
       st.floats(0.0625, 1.0, width=32))
def test_cull_keeps_every_hit_hypothesis(pts, grid, radius):
    keep = np.linalg.norm(pts.astype(np.float64), axis=-1) <= 1.0
    cells = grid_cell_centers(*grid)
    assert _dropped(pts, keep, cells, float(radius), grid[2])[0] == 0


def test_cull_takes_the_magnitude_of_a_negative_radius():
    """The exact test squares the radius; the cull must not shrink by its
    sign."""
    rs = np.random.RandomState(3)
    cells = grid_cell_centers(3, 7, 20)
    pts = _ball(rs, 4, 256)
    mask = np.ones(pts.shape[:2], bool)
    dropped, hits, _, _ = _dropped(pts, mask, cells, -DELTA / 3, 20)
    assert hits > 0 and dropped == 0


def test_ring_keyword_guards():
    cells = torch.from_numpy(grid_cell_centers(3, 7, 20))
    patches = torch.zeros((2, 16, 3))
    mask = torch.ones((2, 16), dtype=torch.bool)
    for ring_len in (0, 16, 840):
        with pytest.raises(ValueError, match="multiple of the ring"):
            spt_cell_query_plain(patches, mask, cells, 0.3, 4,
                                 ring_len=ring_len)
        with pytest.raises(ValueError, match="multiple of the ring"):
            spt_moments_plain(patches, mask, cells, 0.09, ring_len=ring_len)
        with pytest.raises(ValueError, match="multiple of the ring"):
            spt_cell_query_cuda(patches, mask, cells, 0.3, 4,
                                ring_len=ring_len)
        with pytest.raises(ValueError, match="multiple of the ring"):
            spt_moments_cuda(patches, mask, cells, 0.09, ring_len=ring_len)
    # a valid ring length reaches the kernel wrappers' device check
    with pytest.raises(ValueError, match="CUDA tensor"):
        spt_moments_cuda(patches, mask, cells, 0.09, ring_len=20)
    # more cells than a block's shared memory holds: named, before any launch
    many = torch.zeros((20 * 800, 3))
    with pytest.raises(ValueError, match="G = 16000 .* shared memory"):
        spt_moments_cuda(patches, mask, many, 0.09, ring_len=20)
    with pytest.raises(ValueError, match="G = 16000 .* shared memory"):
        spt_cell_query_cuda(patches, mask, many, 0.3, 4, ring_len=20)
