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


def _edge_case(name):
    """Seeded edge shapes of kernel K1 (8 blocks x 256 threads own a cloud):
    (xyz [B, N, 3], mask [B, N], rounds)."""
    rs = np.random.RandomState(11)
    grid = name == "duplicated_grid"
    n, valid, k = {
        "duplicated_grid": (4096, (4096, 3000), 200),   # ties across blocks
        "rounds_past_valid": (1000, (300,), 512),
        "all_padded": (500, (0, 0), 32),
        "ragged_n": (2500, (2500, 7), 100),             # not a multiple of 2048
        "one_cloud": (600, (450,), 64),
        "five_clouds": (600, (600, 1, 300, 599, 100), 64),
    }[name]
    if grid:
        xyz = rs.randint(0, 4, size=(len(valid), n, 3)).astype(np.float32)
    else:
        xyz = (rs.randn(len(valid), n, 3) * [1.0, 2.0, 0.5]).astype(np.float32)
    mask = np.zeros((len(valid), n), bool)
    for b, v in enumerate(valid):
        mask[b, :v] = True
    return xyz, mask, k


@pytest.mark.parametrize("name", [
    "duplicated_grid", "rounds_past_valid", "all_padded", "ragged_n",
    "one_cloud", "five_clouds",
])
def test_fps_plain_edge_shapes_match_jax_exactly(name):
    xyz, mask, k = _edge_case(name)
    raw = farthest_point_sampling_plain(torch.from_numpy(xyz),
                                        torch.from_numpy(mask), k).numpy()
    assert raw.dtype == np.int32 and raw.shape == (len(xyz), k)
    for b in range(len(xyz)):
        j_idx, j_v = farthest_point_sampling(
            jnp.asarray(xyz[b]), jnp.asarray(mask[b]), k)
        # the JAX loop returns finalized indices: past the valid count, the
        # first pick
        valid_out = np.arange(k) < mask[b].sum()
        np.testing.assert_array_equal(valid_out, np.asarray(j_v))
        np.testing.assert_array_equal(np.where(valid_out, raw[b], raw[b, 0]),
                                      np.asarray(j_idx))
    if name == "all_padded":
        assert not raw.any()          # every round picks index 0


def test_fps_kernel_wrapper_guards():
    # the kernel reads the bool mask and [B, N, 3] as they are: it refuses
    # CPU tensors, and sizes it cannot own (checked before the device)
    xyz = torch.zeros(1, 40000, 3)
    with pytest.raises(ValueError, match="1 to 32768 points"):
        farthest_point_sampling_cuda(xyz, torch.ones(1, 40000, dtype=torch.bool), 4)
    with pytest.raises(ValueError, match="1 to 32768 points"):
        farthest_point_sampling_cuda(torch.zeros(1, 0, 3),
                                     torch.ones(1, 0, dtype=torch.bool), 4)
