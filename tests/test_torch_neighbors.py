"""Port parity: distance matrices, mutual matching and radius estimation.

The port's geometry d2 is the plain f32 expansion on centroid-centred
coordinates; the JAX package's is a bf16 hi/lo-compensated product
(error <= 2^-16 |a||b|). In-radius tests on the two may flip for points
within that error of a sphere: bound 1 in 10^4 of the (probe, point)
tests per radius (measured 0 here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.kernels import neighbors as jnb
from bufferx_tpu.kernels.radius import density_aware_radius_from_d2 as j_radius
from bufferx_tpu_torch.kernels import neighbors as tnb
from bufferx_tpu_torch.kernels.radius import density_aware_radius_from_d2

FLIP_RATE_BOUND = 1e-4


def _cloud(seed, n=2048, k=160):
    rs = np.random.RandomState(seed)
    pts = (rs.randn(n, 3) * [0.5, 0.3, 0.2] + [2.0, -1.0, 0.5]).astype(np.float32)
    mask = np.ones(n, bool)
    mask[n - 150:] = False
    probes = pts[rs.choice(n - 150, k, replace=False)]
    pmask = np.ones(k, bool)
    pmask[-7:] = False
    c = pts[mask].mean(0)
    return pts - c, mask, probes - c, pmask


@pytest.mark.parametrize("seed", [0, 1])
def test_d2_in_radius_flip_rate(seed):
    pts, mask, probes, pmask = _cloud(seed)
    want = np.asarray(jnb.masked_sqdist(
        jnp.asarray(probes), jnp.asarray(pts), jnp.asarray(pmask),
        jnp.asarray(mask), precise=False))
    got = tnb.masked_sqdist(torch.from_numpy(probes), torch.from_numpy(pts),
                            torch.from_numpy(pmask),
                            torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got >= 1e29, want >= 1e29)
    # |a|, |b| <= ~1.6 here: the JAX side's 2^-16 |a||b| is <= 4e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for r in (0.05, 0.1, 0.2, 0.4):
        flips = np.sum((got <= r * r) != (want <= r * r))
        assert flips <= FLIP_RATE_BOUND * got.size, (r, flips)


def test_mutual_nearest_matches_jax():
    rs = np.random.RandomState(3)
    a = rs.randn(128, 32).astype(np.float32)
    b = (a[rs.permutation(128)] + 0.3 * rs.randn(128, 32)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    ma = rs.uniform(size=128) < 0.9
    mb = rs.uniform(size=128) < 0.9
    j_nn, j_mut, j_d2 = jnb.mutual_nearest(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(ma), jnp.asarray(mb))
    t_nn, t_mut, t_d2 = tnb.mutual_nearest(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(ma),
        torch.from_numpy(mb))
    np.testing.assert_array_equal(t_nn.numpy(), np.asarray(j_nn))
    np.testing.assert_array_equal(t_mut.numpy(), np.asarray(j_mut))
    np.testing.assert_allclose(t_d2.numpy(), np.asarray(j_d2), rtol=0,
                               atol=1e-5)
    assert t_mut.sum() > 20


@pytest.mark.parametrize("subsample", [1, 4])
def test_radius_matches_jax(subsample):
    pts, mask, probes, pmask = _cloud(4)
    d2 = tnb.masked_sqdist(torch.from_numpy(probes), torch.from_numpy(pts),
                           torch.from_numpy(pmask), torch.from_numpy(mask))
    th = (5.0, 2.0, 0.5)
    want = np.asarray(j_radius(jnp.asarray(d2.numpy()), jnp.asarray(mask),
                               jnp.asarray(pmask), th, 5.0, subsample))
    got = density_aware_radius_from_d2(d2, torch.from_numpy(mask),
                                       torch.from_numpy(pmask), th, 5.0,
                                       subsample).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] > got[1] > got[2] > 0
