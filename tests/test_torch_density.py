"""The clutter prefilter against the JAX package's ``density_inlier_mask``,
on ``hard_pair`` eval clouds (overlap 0.5, half-voxel noise) with clutter
0, 0.1 and 0.2, padded by ``prepare_cloud`` to 6144 slots, and on
degenerate clouds.

Tolerance: the JAX function's d2 is computed inside its ``jit``, where XLA
fuses ``|a|^2 - 2 a.b + |b|^2`` and rounds 13-17% of the entries in other
last bits than the same expression run op by op (measured; the eager JAX
d2 equals the port's bit for bit). A point whose anchor count sits at the
keep threshold then flips. Measured on these clouds: 1-2 of 3997 valid
slots without clutter, 12-16 of 4393-4791 (0.27-0.33%) with clutter;
pinned at 0.2% and 1% per cloud, and the numbers of removed points within
3% + 2 of each other. The batch of clouds equals the clouds filtered one at
a time bit for bit. The guard (keep the mask where under
``min_keep_frac`` would stay) holds as in JAX, and an empty cloud stays
empty.
"""

import numpy as np
import pytest
import torch

from bufferx_tpu.kernels.density import density_inlier_mask as jax_density
from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.data.hardsynth import hard_pair
from bufferx_tpu_torch.kernels.density import density_inlier_mask
from bufferx_tpu_torch.pipeline.registration import prepare_cloud

CFG = make_cfg("3DMatch").override(capacity=dict(max_points=6144))


def _clouds(clutter):
    s, t, _T = hard_pair(np.random.RandomState(int(clutter * 10)),
                         num_points=6000, overlap_ratio=0.5, noise=0.0125,
                         outlier_frac=clutter)
    clouds = [prepare_cloud(c, CFG, seed=k, device="cpu")
              for k, c in enumerate((s, t))]
    return (torch.stack([c.xyz for c in clouds]),
            torch.stack([c.mask for c in clouds]))


def _jax(xyz, mask):
    return np.stack([np.asarray(jax_density(x.numpy(), m.numpy()))
                     for x, m in zip(xyz, mask)])


@pytest.mark.parametrize("clutter", [0.0, 0.1, 0.2])
def test_matches_jax(clutter):
    xyz, mask = _clouds(clutter)
    got = density_inlier_mask(xyz, mask).numpy()
    want = _jax(xyz, mask)
    m = mask.numpy()
    assert not (got & ~m).any()                   # never adds a point
    for c in range(2):
        flips = int((got[c] != want[c]).sum())
        assert flips <= (0.01 if clutter else 0.002) * m[c].sum(), (c, flips)
        removed_t = int((m[c] & ~got[c]).sum())
        removed_j = int((m[c] & ~want[c]).sum())
        assert abs(removed_t - removed_j) <= 0.03 * removed_j + 2
        if clutter > 0:
            # it removes about as many points as the clutter added
            n_out = m[c].sum() - round(m[c].sum() / (1 + clutter))
            assert 0.5 * n_out <= removed_t <= 1.5 * n_out


def test_batch_equals_single_clouds():
    parts = [_clouds(c) for c in (0.0, 0.2)]
    xyz = torch.cat([p[0] for p in parts])
    mask = torch.cat([p[1] for p in parts])
    batch = density_inlier_mask(xyz, mask)
    for c in range(xyz.shape[0]):
        assert torch.equal(batch[c],
                           density_inlier_mask(xyz[c:c + 1], mask[c:c + 1])[0])


@pytest.mark.parametrize("min_keep_frac", [0.0, 0.5, 0.99])
def test_guard_and_empty_cloud(min_keep_frac):
    """The guard against JAX's: at 0.99 the clutter cloud would lose more
    than 1% and keeps its mask; at 0.5 (the default) the filter's result
    stands (the points at or above the median count, at least half of a
    cloud, are always kept); at 0 it always stands. An empty cloud stays
    empty under each."""
    xyz, mask = _clouds(0.2)
    xyz = torch.cat([xyz, torch.zeros_like(xyz[:1])])
    mask = torch.cat([mask, torch.zeros_like(mask[:1])])
    got = density_inlier_mask(xyz, mask, min_keep_frac=min_keep_frac)
    want = np.stack([
        np.asarray(jax_density(x.numpy(), m.numpy(),
                               min_keep_frac=min_keep_frac))
        for x, m in zip(xyz, mask)])
    assert not got[2].any() and not want[2].any()
    for c in range(2):
        if min_keep_frac > 0.5:
            assert torch.equal(got[c], mask[c])
            assert np.array_equal(want[c], mask[c].numpy())
        else:
            assert int((got[c] != torch.from_numpy(want[c])).sum()) <= \
                0.01 * int(mask[c].sum())
            assert int(got[c].sum()) < 0.9 * int(mask[c].sum())
