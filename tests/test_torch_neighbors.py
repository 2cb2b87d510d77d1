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
    """A batch of three pairs in one call against the JAX function pair by
    pair."""
    rs = np.random.RandomState(3)
    a = rs.randn(3, 128, 32).astype(np.float32)
    b = np.stack([x[rs.permutation(128)] for x in a])
    b = (b + 0.3 * rs.randn(3, 128, 32)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    ma = rs.uniform(size=(3, 128)) < 0.9
    mb = rs.uniform(size=(3, 128)) < 0.9
    t_nn, t_mut, t_d2 = tnb.mutual_nearest(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(ma),
        torch.from_numpy(mb))
    for i in range(3):
        j_nn, j_mut, j_d2 = jnb.mutual_nearest(
            jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(ma[i]),
            jnp.asarray(mb[i]))
        np.testing.assert_array_equal(t_nn[i].numpy(), np.asarray(j_nn))
        np.testing.assert_array_equal(t_mut[i].numpy(), np.asarray(j_mut))
        np.testing.assert_allclose(t_d2[i].numpy(), np.asarray(j_d2), rtol=0,
                                   atol=1e-5)
        assert t_mut[i].sum() > 20


@pytest.mark.parametrize("subsample", [1, 4])
def test_radius_matches_jax(subsample):
    """Two clouds of different densities as one batch against the JAX
    function cloud by cloud."""
    clouds = [_cloud(4), _cloud(5)]
    p1, m1, pr1, pm1 = clouds[1]
    clouds[1] = (p1 * 1.7, m1, pr1 * 1.7, pm1)
    pts, mask, probes, pmask = (torch.from_numpy(np.stack(x))
                                for x in zip(*clouds))
    d2 = tnb.masked_sqdist(probes, pts, pmask, mask)
    th = (5.0, 2.0, 0.5)
    got = density_aware_radius_from_d2(d2, mask, pmask, th, 5.0,
                                       subsample).numpy()
    assert got.shape == (2, 3)
    for i in range(2):
        want = np.asarray(j_radius(
            jnp.asarray(d2[i].numpy()), jnp.asarray(mask[i].numpy()),
            jnp.asarray(pmask[i].numpy()), th, 5.0, subsample))
        np.testing.assert_array_equal(got[i], want)
        assert got[i, 0] > got[i, 1] > got[i, 2] > 0
    assert (got[1] > got[0]).all()        # the sparser cloud: larger radii


def _radius_cases():
    """(name, pts, mask, kpts, kmask): the two clouds of
    ``tests/test_kernels.py``'s radius tests (a clean one, and a masked one
    whose masked points lie far away) and a ``hard_pair`` source with its
    FPS probes."""
    from bufferx_tpu_torch.data.hardsynth import hard_pair
    from bufferx_tpu_torch.kernels.fps import farthest_point_sampling_plain

    rs = np.random.RandomState(0)
    pts = rs.randn(3000, 3).astype(np.float32)
    yield "clean", pts, np.ones(3000, bool), pts[:200], np.ones(200, bool)
    far = pts[:1000].copy()
    far[500:] *= 100
    mask = np.arange(1000) < 500
    yield "masked", far, mask, pts[:100], np.ones(100, bool)
    src = hard_pair(np.random.RandomState(11), num_points=4000)[0]
    src = src.astype(np.float32)
    smask = np.ones(len(src), bool)
    idx = farthest_point_sampling_plain(torch.from_numpy(src)[None],
                                        torch.from_numpy(smask)[None], 256)[0]
    yield "hard_pair", src, smask, src[idx.numpy()], np.ones(256, bool)


def test_density_aware_radius_matches_jax():
    """The point form: the port's float32 ``sqdist`` then the bisection,
    against the JAX function (its precise ``sqdist``) on each case, one at
    a time and as a batch. The radii are equal after the rounding to 2
    decimals; a distance within an ulp of a bf16 rounding boundary may
    flip one bisection step, which moves a radius by one step, 0.01, and
    no more (measured: equal on all three)."""
    from bufferx_tpu.kernels.radius import density_aware_radius as j_dar
    from bufferx_tpu_torch.kernels.radius import density_aware_radius

    th = (5.0, 2.0, 0.5)
    for name, pts, mask, kpts, kmask in _radius_cases():
        want = np.asarray(j_dar(jnp.asarray(pts), jnp.asarray(mask),
                                jnp.asarray(kpts), jnp.asarray(kmask), th))
        args = [torch.from_numpy(x) for x in (pts, mask, kpts, kmask)]
        got = density_aware_radius(*args, th).numpy()
        assert got.shape == (3,) and got.dtype == np.float32, name
        np.testing.assert_allclose(got, want, rtol=0, atol=0.01 + 1e-6,
                                   err_msg=name)
        batch = density_aware_radius(*(a[None] for a in args), th)
        np.testing.assert_array_equal(batch[0].numpy(), got)
        assert got[0] > got[1] > got[2] > 0, name
