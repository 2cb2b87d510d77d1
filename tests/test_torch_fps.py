"""Port parity: FPS (plain version of kernel K1) against the JAX package.

Indices must match exactly: both compute (dx*dx + dy*dy) + dz*dz in the
same order and break argmax ties to the lowest index.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.kernels.fps import farthest_point_sampling
from bufferx_tpu_torch.kernels.fps import (
    farthest_point_sampling_cuda,
    farthest_point_sampling_plain,
    fps,
)


def _clouds(seed, n, valid_counts):
    rs = np.random.RandomState(seed)
    xyz = (rs.randn(len(valid_counts), n, 3) * [1.0, 2.0, 0.5]).astype(np.float32)
    mask = np.zeros((len(valid_counts), n), bool)
    for b, v in enumerate(valid_counts):
        mask[b, :v] = True
    return xyz, mask


@pytest.mark.parametrize("seed,n,valid,k", [
    (0, 2048, (1900, 2048), 160),
    (1, 1024, (1024, 700), 128),
    (2, 512, (40, 512), 64),       # fewer valid points than samples
])
def test_fps_matches_jax_exactly(seed, n, valid, k):
    xyz, mask = _clouds(seed, n, valid)
    idx, v = fps(torch.from_numpy(xyz), torch.from_numpy(mask), k)
    for b in range(len(valid)):
        j_idx, j_v = farthest_point_sampling(
            jnp.asarray(xyz[b]), jnp.asarray(mask[b]), k
        )
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(v[b].numpy(), np.asarray(j_v))


def test_fps_on_grid_ties():
    # a regular grid has many equal distances: ties must go to the lowest
    g = np.stack(np.meshgrid(*[np.arange(8.0)] * 3, indexing="ij"), -1)
    xyz = g.reshape(1, -1, 3).astype(np.float32)
    mask = np.ones((1, xyz.shape[1]), bool)
    raw = farthest_point_sampling_plain(torch.from_numpy(xyz),
                                        torch.from_numpy(mask), 50)
    j_idx, _ = farthest_point_sampling(jnp.asarray(xyz[0]),
                                       jnp.asarray(mask[0]), 50)
    np.testing.assert_array_equal(raw[0].numpy(), np.asarray(j_idx))


def test_fps_input_checks():
    with pytest.raises(ValueError):
        fps(torch.zeros(10, 3), torch.ones(10, dtype=torch.bool), 4)
    # the kernel wrapper takes CUDA tensors only; it never runs the plain
    # version itself
    with pytest.raises(ValueError):
        farthest_point_sampling_cuda(torch.zeros(1, 10, 3),
                                     torch.ones(1, 10, dtype=torch.bool), 4)
