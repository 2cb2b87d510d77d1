"""Port parity: the SPT cell query (plain version of kernel K4), the
derotation and the spatial point transformer, against
:mod:`bufferx_tpu.geometry.cylindrical` and the Pallas kernel in interpret
mode.

The port's in-radius test is the f32 ``(dx*dx + dy*dy) + dz*dz <= r^2``;
the JAX CPU path evaluates ``|c|^2 - 2 c.p + |p|^2`` and the Pallas kernel
a bf16 hi/lo-compensated product, so a point within rounding of a cell's
sphere can fall on either side and change that cell's selection. Bound: at
most 1 in 10^3 of the (patch, cell) rows may select differently (measured 0
of 29,400 rows against the f32 JAX path and 0 of 2,520 against the Pallas
kernel).
Rows that select the same points agree to 1e-6 (the JAX extraction is a
one-hot matmul on the Pallas side; the coordinates themselves are copied).
The derotation is a 3x3 rotation per azimuth column in f32 on both sides:
1e-6 absolute on unit-radius points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.geometry.cylindrical import _cell_query_one
from bufferx_tpu.geometry.cylindrical import (
    spatial_point_transformer as jax_spt,
)
from bufferx_tpu.geometry.cylindrical import var_to_invar as jax_invar
from bufferx_tpu.geometry.spt_pallas import spt_cell_query_pallas
from bufferx_tpu_torch.geometry.cylindrical import (
    grid_cell_centers,
    spatial_point_transformer,
    var_to_invar,
)
from bufferx_tpu_torch.geometry.spt_pallas import (
    spt_cell_query,
    spt_cell_query_cuda,
    spt_cell_query_plain,
)

RAD, ELE, AZI, DELTA, NS = 3, 7, 20, 0.8, 10
RADIUS = DELTA / RAD
ROW_FLIP_BOUND = 1e-3


def _jax_query(patches, mask, cells, radius, ns):
    return np.asarray(jax.vmap(
        lambda pp, mm: _cell_query_one(pp, mm, cells, radius, ns,
                                       use_approx=False)
    )(jnp.asarray(patches), jnp.asarray(mask)))


def _port_query(patches, mask, cells, radius, ns, ring_len=None):
    return spt_cell_query_plain(torch.from_numpy(patches),
                                torch.from_numpy(mask),
                                torch.from_numpy(np.asarray(cells)),
                                radius, ns, ring_len=ring_len).numpy()


def _assert_rows_match(got, want):
    """Rows (patch, cell) whose selection differs stay under the bound;
    the others agree to 1e-6."""
    assert got.shape == want.shape
    differ = np.abs(got - want).reshape(*got.shape[:2], -1).max(-1) > 1e-6
    assert differ.sum() <= ROW_FLIP_BOUND * differ.size, differ.sum()


@pytest.mark.parametrize("p,seed", [(128, 0), (384, 1)])
def test_query_matches_jax_and_pallas(p, seed):
    rs = np.random.RandomState(seed)
    k = 3
    cells = grid_cell_centers(RAD, ELE, AZI)
    patches = (rs.randn(k, p, 3) * 0.4).astype(np.float32)
    mask = np.ones((k, p), bool)
    mask[:, p - 28:] = False
    got = _port_query(patches, mask, cells, RADIUS, NS)
    assert got.shape == (k, RAD * ELE * AZI, NS, 3)
    _assert_rows_match(got, _jax_query(patches, mask, cells, RADIUS, NS))
    pallas = np.asarray(spt_cell_query_pallas(
        jnp.asarray(patches), jnp.asarray(mask), jnp.asarray(cells), RADIUS,
        NS, interpret=True))
    _assert_rows_match(got, pallas)


@pytest.mark.parametrize("grid,ring_len", [((3, 7, 20), 20), ((3, 7, 20), 1),
                                           ((3, 7, 20), 140), ((2, 3, 5), 5),
                                           ((1, 1, 1), 1)])
def test_ring_keyword_changes_nothing(grid, ring_len):
    """The plain version checks ``ring_len`` and runs no cull: the same bits
    with and without it (tolerance 0)."""
    rs = np.random.RandomState(6)
    cells = grid_cell_centers(*grid)
    patches = (rs.randn(4, 256, 3) * 0.4).astype(np.float32)
    mask = rs.uniform(size=(4, 256)) < 0.9
    radius = DELTA / grid[0]
    want = _port_query(patches, mask, cells, radius, NS)
    assert np.abs(want).sum() > 0
    np.testing.assert_array_equal(
        _port_query(patches, mask, cells, radius, NS, ring_len), want)


def test_query_with_ring_keyword_matches_jax_and_pallas():
    """As the sampled path calls it (``ring_len=azi_n``), against the f32
    JAX path and the Pallas kernel in interpret mode."""
    rs = np.random.RandomState(7)
    k, p = 3, 256
    cells = grid_cell_centers(RAD, ELE, AZI)
    patches = (rs.randn(k, p, 3) * 0.4).astype(np.float32)
    mask = rs.uniform(size=(k, p)) < 0.9
    got = _port_query(patches, mask, cells, RADIUS, NS, ring_len=AZI)
    _assert_rows_match(got, _jax_query(patches, mask, cells, RADIUS, NS))
    pallas = np.asarray(spt_cell_query_pallas(
        jnp.asarray(patches), jnp.asarray(mask), jnp.asarray(cells), RADIUS,
        NS, interpret=True))
    _assert_rows_match(got, pallas)


def test_flip_rate_against_jax_at_patch_width():
    """K = 8 unit-ball patches of 512 points: the rate of (patch, cell) rows
    whose selection differs from the f32 JAX path."""
    rs = np.random.RandomState(2)
    v = rs.randn(8, 512, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    patches = (v * rs.uniform(0, 1, (8, 512, 1)) ** (1 / 3)).astype(np.float32)
    mask = rs.uniform(size=(8, 512)) < 0.9
    cells = grid_cell_centers(RAD, ELE, AZI)
    got = _port_query(patches, mask, cells, RADIUS, NS)
    _assert_rows_match(got, _jax_query(patches, mask, cells, RADIUS, NS))


def test_row_order_and_short_cells():
    # one cell, in-radius points at rows [5, 9, 20, 40]: the first two win,
    # in that order; with nsample 10, slots 4..9 stay zero
    cells = grid_cell_centers(1, 1, 1)
    patches = np.full((1, 64, 3), 100.0, np.float32)
    for r, off in [(5, 0.01), (9, -0.01), (20, 0.02), (40, -0.02)]:
        patches[0, r] = cells[0] + off
    mask = np.ones((1, 64), bool)
    two = _port_query(patches, mask, cells, 0.1, 2)
    np.testing.assert_array_equal(two[0, 0], patches[0, [5, 9]])
    ten = _port_query(patches, mask, cells, 0.1, 10)
    np.testing.assert_array_equal(ten[0, 0, :4], patches[0, [5, 9, 20, 40]])
    assert np.all(ten[0, 0, 4:] == 0.0)
    np.testing.assert_array_equal(
        ten, _jax_query(patches, mask, cells, 0.1, 10))
    mask[0, 9] = False                     # a masked row is never selected
    np.testing.assert_array_equal(
        _port_query(patches, mask, cells, 0.1, 2)[0, 0], patches[0, [5, 20]])


def test_empty_patch_all_zero():
    cells = grid_cell_centers(RAD, ELE, AZI)
    patches = np.full((2, 64, 3), 0.1, np.float32)
    mask = np.zeros((2, 64), bool)
    out = _port_query(patches, mask, cells, RADIUS, NS)
    assert out.shape == (2, RAD * ELE * AZI, NS, 3) and np.all(out == 0.0)


def test_var_to_invar_matches_jax():
    rs = np.random.RandomState(3)
    pts = rs.uniform(-1, 1, (4, RAD * ELE * AZI, NS, 3)).astype(np.float32)
    want = np.asarray(jax_invar(jnp.asarray(pts), RAD, ELE, AZI))
    got = var_to_invar(torch.from_numpy(pts), RAD, ELE, AZI).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_spatial_point_transformer_matches_jax():
    """K = 8, P = 512, G = 420, ns = 10, through the JAX package's default
    (``approx_max_k``, exact on the CPU)."""
    rs = np.random.RandomState(4)
    patches = (rs.randn(8, 512, 3) * 0.45).astype(np.float32)
    mask = rs.uniform(size=(8, 512)) < 0.85
    want = np.asarray(jax_spt(jnp.asarray(patches), jnp.asarray(mask), RAD,
                              ELE, AZI, DELTA, NS))
    got = spatial_point_transformer(torch.from_numpy(patches),
                                    torch.from_numpy(mask), RAD, ELE, AZI,
                                    DELTA, NS).numpy()
    assert got.shape == want.shape == (8, RAD * ELE * AZI, NS, 3)
    _assert_rows_match(got, want)


def test_dispatch_and_guards():
    cells = torch.from_numpy(grid_cell_centers(RAD, ELE, AZI))
    patches = torch.zeros((2, 16, 3))
    mask = torch.ones((2, 16), dtype=torch.bool)
    out = spt_cell_query(patches, mask, cells, RADIUS, NS)
    assert out.shape == (2, RAD * ELE * AZI, NS, 3)
    with pytest.raises(ValueError):   # kernel wrapper: CUDA tensors only
        spt_cell_query_cuda(patches, mask, cells, RADIUS, NS)
    with pytest.raises(ValueError, match="nsample"):
        spt_cell_query_cuda(patches, mask, cells, RADIUS, 33)
    # the ring length must divide the number of cells, on every entry
    for fn in (spt_cell_query, spt_cell_query_plain, spt_cell_query_cuda):
        with pytest.raises(ValueError, match="multiple of the ring"):
            fn(patches, mask, cells, RADIUS, NS, ring_len=AZI + 3)
    np.testing.assert_array_equal(
        spt_cell_query(patches, mask, cells, RADIUS, NS, ring_len=AZI), out)
