"""Port parity: SPT moment pooling (plain version of kernel K3) and the
moments-major derotation.

The port's in-radius test is the f32 ``(dx*dx + dy*dy) + dz*dz <= r^2``;
the JAX CPU path evaluates ``|c|^2 - 2 c.p + |p|^2`` and the Pallas kernel a
bf16 hi/lo-compensated product, so a point within rounding of a cell's
sphere can fall on either side. Bound: at most 1 in 10^4 of the
(patch, cell, point) tests may flip (measured over 7.7e6 tests: 0 against
the f32 JAX path, 3 against the Pallas kernel). Cells whose count agrees
must agree in every sum to 1e-5 against the f32 JAX path (measured
9.5e-7), and to 2^-7 of the cell's summed |moment| against the Pallas
kernel, whose moment products are bf16 (measured 3.9e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.geometry import moments as jmom
from bufferx_tpu.geometry.cylindrical import grid_cell_centers as j_cells
from bufferx_tpu.geometry.spt_pallas import spt_moments_pallas
from bufferx_tpu_torch.geometry import moments as tmom
from bufferx_tpu_torch.geometry.cylindrical import grid_cell_centers
from bufferx_tpu_torch.geometry.spt_pallas import (
    point_moment_features,
    spt_moments,
    spt_moments_cuda,
    spt_moments_plain,
)

RAD, ELE, AZI, DELTA = 3, 7, 20, 0.8
FLIP_RATE_BOUND = 1e-4


def _patches(seed, k=24, p=128):
    rs = np.random.RandomState(seed)
    v = rs.randn(k, p, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = (v * rs.uniform(0, 1, (k, p, 1)) ** (1 / 3)).astype(np.float32)
    mask = rs.uniform(size=(k, p)) < 0.8
    pts[~mask] = 0.0                       # invalid slots: zero offsets
    return pts, mask


def _abs_moment_scale(pts, mask):
    """Per (patch, moment, cell) sum of |psi| over in-radius points."""
    psi = point_moment_features(torch.from_numpy(pts).abs(),
                                torch.from_numpy(mask))
    cells = torch.from_numpy(grid_cell_centers(RAD, ELE, AZI))
    r = DELTA / RAD
    d = torch.cdist(cells[None].expand(len(pts), -1, -1), torch.from_numpy(pts))
    return torch.bmm((d <= r * 1.001).float(), psi).transpose(1, 2).numpy()


def test_grid_cells_match():
    np.testing.assert_array_equal(grid_cell_centers(RAD, ELE, AZI),
                                  j_cells(RAD, ELE, AZI))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_matches_jax_cpu_path(seed):
    pts, mask = _patches(seed)
    want = np.asarray(jmom.pool_cell_moments(
        jnp.asarray(pts), jnp.asarray(mask), RAD, ELE, AZI, DELTA,
        moments_major=True,
    ))
    got = tmom.pool_cell_moments(torch.from_numpy(pts), torch.from_numpy(mask),
                                 RAD, ELE, AZI, DELTA).numpy()
    assert got.shape == want.shape == (len(pts), 10, RAD * ELE * AZI)
    flips = np.abs(got[:, 9] - want[:, 9]).sum()
    assert flips <= FLIP_RATE_BOUND * pts.shape[0] * pts.shape[1] * want.shape[2]
    same = (got[:, 9] == want[:, 9])[:, None, :]
    np.testing.assert_allclose(np.where(same, got, 0), np.where(same, want, 0),
                               rtol=0, atol=1e-5)


def test_pool_matches_pallas_interpret():
    pts, mask = _patches(3, k=16)
    cells = jnp.asarray(j_cells(RAD, ELE, AZI))
    want = np.asarray(spt_moments_pallas(
        jnp.asarray(pts), jnp.asarray(mask), cells, DELTA / RAD,
        interpret=True, moments_major=True,
    ))
    got = tmom.pool_cell_moments(torch.from_numpy(pts), torch.from_numpy(mask),
                                 RAD, ELE, AZI, DELTA).numpy()
    flips = np.abs(got[:, 9] - want[:, 9]).sum()
    assert flips <= FLIP_RATE_BOUND * pts.shape[0] * pts.shape[1] * want.shape[2]
    same = (got[:, 9] == want[:, 9])[:, None, :]
    scale = _abs_moment_scale(pts, mask)
    assert np.all(np.where(same, np.abs(got - want) <= 2**-7 * scale + 1e-6,
                           True))


@pytest.mark.parametrize("grid,ring_len", [((3, 7, 20), 20), ((3, 7, 20), 1),
                                           ((3, 7, 20), 140), ((2, 3, 5), 5),
                                           ((1, 1, 1), 1)])
def test_ring_keyword_changes_nothing(grid, ring_len):
    """The plain version checks ``ring_len`` and runs no cull: the same bits
    with and without it (tolerance 0)."""
    pts, mask = _patches(6, k=6)
    cells = torch.from_numpy(grid_cell_centers(*grid))
    r2 = (DELTA / grid[0]) ** 2
    want = spt_moments_plain(torch.from_numpy(pts), torch.from_numpy(mask),
                             cells, r2)
    got = spt_moments_plain(torch.from_numpy(pts), torch.from_numpy(mask),
                            cells, r2, ring_len=ring_len)
    assert float(want[:, 9].sum()) > 0
    assert torch.equal(got, want)


def test_pool_is_called_with_the_ring_keyword(monkeypatch):
    """``pool_cell_moments`` tells the kernel wrapper the ring length (the
    grid's ``azi_n``), and the result still matches the f32 JAX path."""
    seen = {}
    real = tmom.spt_moments

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(tmom, "spt_moments", spy)
    pts, mask = _patches(7, k=4)
    got = tmom.pool_cell_moments(torch.from_numpy(pts), torch.from_numpy(mask),
                                 RAD, ELE, AZI, DELTA).numpy()
    assert seen == {"ring_len": AZI}
    want = np.asarray(jmom.pool_cell_moments(
        jnp.asarray(pts), jnp.asarray(mask), RAD, ELE, AZI, DELTA,
        moments_major=True,
    ))
    same = (got[:, 9] == want[:, 9])[:, None, :]
    assert same.mean() > 1 - FLIP_RATE_BOUND * pts.shape[1]
    np.testing.assert_allclose(np.where(same, got, 0), np.where(same, want, 0),
                               rtol=0, atol=1e-5)


def test_features_mm_match_jax():
    pts, mask = _patches(4)
    raw = tmom.pool_cell_moments(torch.from_numpy(pts), torch.from_numpy(mask),
                                 RAD, ELE, AZI, DELTA)
    want = np.asarray(jmom.moments_to_features_mm(
        jnp.asarray(raw.numpy()), RAD, ELE, AZI, DELTA))
    got = tmom.moments_to_features_mm(raw, RAD, ELE, AZI, DELTA).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_dispatch_and_guards():
    pts, mask = _patches(5, k=2, p=16)
    cells = torch.from_numpy(grid_cell_centers(RAD, ELE, AZI))
    out = spt_moments(torch.from_numpy(pts), torch.from_numpy(mask), cells, 0.07)
    assert out.shape == (2, 10, RAD * ELE * AZI)
    with pytest.raises(ValueError):   # kernel wrapper: CUDA tensors only
        spt_moments_cuda(torch.from_numpy(pts), torch.from_numpy(mask),
                         cells, 0.07)
    # the ring length must divide the number of cells, on every entry
    for fn in (spt_moments, spt_moments_plain, spt_moments_cuda):
        with pytest.raises(ValueError, match="multiple of the ring"):
            fn(torch.from_numpy(pts), torch.from_numpy(mask), cells, 0.07,
               ring_len=AZI + 3)
    assert torch.equal(
        spt_moments(torch.from_numpy(pts), torch.from_numpy(mask), cells,
                    0.07, ring_len=AZI), out)
