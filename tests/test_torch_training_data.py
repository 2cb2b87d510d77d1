"""Port parity of the training data: ``voxel_downsample_np``,
``synthetic_pair``, ``rotate_pair``, ``random_des_r``,
``build_training_batch``, ``synthetic_training_stream`` and
``hard_training_stream`` with ``host_arrays=True`` are bit-equal to the JAX
package's for the same seeds (the same numpy code); the device path samples
the same correspondences as the JAX one when given JAX's noise; pools are
stacked once and indexed without copies.
"""

import jax
import numpy as np
import pytest
import torch

from bufferx_tpu.config import make_cfg as jax_make_cfg
from bufferx_tpu.data import hardsynth as jhs
from bufferx_tpu.data import modelnet as jmn
from bufferx_tpu.data import training as jtd
from bufferx_tpu.kernels.voxel import voxel_downsample_np as jax_voxel
from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.data import hardsynth as ths
from bufferx_tpu_torch.data import modelnet as tmn
from bufferx_tpu_torch.data import training as ttd
from bufferx_tpu_torch.kernels.voxel import voxel_downsample_np

TINY = dict(capacity=dict(max_points=1024, sphere_query_chunk=32),
            patch=dict(num_points_per_patch=64), train=dict(pos_num=32))


def _equal_batches(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


@pytest.mark.parametrize("voxel", [0.01, 0.05, 0.3])
def test_voxel_downsample_np(voxel):
    rs = np.random.RandomState(0)
    pts = (rs.randn(3000, 3) * 0.5).astype(np.float32)
    got = voxel_downsample_np(pts, voxel)
    assert np.array_equal(got, jax_voxel(pts, voxel))
    assert len(got) < len(pts) or voxel == 0.01
    assert voxel_downsample_np(pts[:0], voxel).shape == (0, 3)


@pytest.mark.parametrize("overlap", [0.5, 0.8])
def test_synthetic_pair(overlap):
    a = tmn.synthetic_pair(np.random.RandomState(3), 3000, overlap=overlap)
    b = jmn.synthetic_pair(np.random.RandomState(3), 3000, overlap=overlap)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    pts = np.random.RandomState(1).randn(500, 3).astype(np.float32)
    for x, y in zip(tmn.make_pair_from_points(pts, np.random.RandomState(2)),
                    jmn.make_pair_from_points(pts, np.random.RandomState(2))):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("mode", ["so3", "so2", "none"])
def test_rotate_pair_and_radius(mode):
    rs = np.random.RandomState(5)
    s, t = rs.randn(2, 200, 3).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    a = ttd.rotate_pair(s, t, T, np.random.RandomState(6), mode)
    b = jtd.rotate_pair(s, t, T, np.random.RandomState(6), mode)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    for name in ("ModelNet40", "KITTI", "3DMatch"):
        tcfg, jcfg = make_cfg(name), jax_make_cfg(name)
        for seed in range(5):
            assert ttd.random_des_r(tcfg, np.random.RandomState(seed)) == \
                jtd.random_des_r(jcfg, np.random.RandomState(seed))


@pytest.mark.parametrize("dataset", ["ModelNet40", "KITTI"])
def test_build_training_batch_host_arrays(dataset):
    tcfg = make_cfg(dataset).override(**TINY)
    jcfg = jax_make_cfg(dataset).override(**TINY)
    scale = 1.0 if dataset == "ModelNet40" else 20.0
    s, t, T = jmn.synthetic_pair(np.random.RandomState(0), 2500, overlap=0.8)
    s, t, T2 = s * scale, t * scale, T.copy()
    T2[:3, 3] *= scale
    a = ttd.build_training_batch(tcfg, s, t, T2, np.random.RandomState(1),
                                 host_arrays=True)
    b = jtd.build_training_batch(jcfg, s, t, T2, np.random.RandomState(1),
                                 None, host_arrays=True)
    _equal_batches(a, b)
    assert a["corr_valid"].sum() > 0


def test_streams_host_arrays():
    tcfg = make_cfg("ModelNet40").override(**TINY)
    jcfg = jax_make_cfg("ModelNet40").override(**TINY)
    a = list(ttd.synthetic_training_stream(tcfg, 2, seed=3, num_points=1500,
                                           host_arrays=True))
    b = list(jtd.synthetic_training_stream(jcfg, 2, seed=3, num_points=1500,
                                           host_arrays=True))
    for x, y in zip(a, b):
        _equal_batches(x, y)
    knobs = dict(overlap_range=(0.3, 0.6), density_choices=(1.0, 4.0),
                 clutter_choices=(0.0, 0.1))
    a = list(ths.hard_training_stream(tcfg, 3, seed=2, num_points=2000,
                                      host_arrays=True, **knobs))
    b = list(jhs.hard_training_stream(jcfg, 3, seed=2, num_points=2000,
                                      host_arrays=True, **knobs))
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        _equal_batches(x, y)


def test_build_training_batch_device_path():
    """host_arrays=False: the correspondences are sampled by the port's
    ``sample_gt_correspondences``; with JAX's noise they are JAX's."""
    tcfg = make_cfg("ModelNet40").override(**TINY)
    jcfg = jax_make_cfg("ModelNet40").override(**TINY)
    s, t, T = jmn.synthetic_pair(np.random.RandomState(0), 2500, overlap=0.8)
    key = jax.random.PRNGKey(4)
    b = jtd.build_training_batch(jcfg, s, t, T, np.random.RandomState(1), key)
    noise = torch.from_numpy(np.array(jax.random.uniform(
        key, (jcfg.capacity.max_points,))))
    a = ttd.build_training_batch(tcfg, s, t, T, np.random.RandomState(1),
                                 host_arrays=False, device="cpu", noise=noise)
    assert a["is_aligned"] is False
    _equal_batches({k: v.numpy() for k, v in a.items() if k != "is_aligned"},
                   {k: np.asarray(v) for k, v in b.items()
                    if k != "is_aligned"})
    # with a generator instead of given noise: the same fixed shapes
    g = torch.Generator().manual_seed(0)
    c = ttd.build_training_batch(tcfg, s, t, T, np.random.RandomState(1), g,
                                 device="cpu")
    assert c["src_kpt"].shape == (32, 3) and c["corr_valid"].sum() > 0
    gen = list(ttd.synthetic_training_stream(tcfg, 1, num_points=1500,
                                             device="cpu"))
    assert gen[0]["src_fds"].shape == (1024, 3)


def test_pool_stack_and_index():
    tcfg = make_cfg("ModelNet40").override(**TINY)
    host = list(ttd.synthetic_training_stream(tcfg, 3, num_points=1500,
                                              host_arrays=True))
    pool = ttd.stack_batches(host, "cpu")
    assert pool["src_fds"].shape == (3, 1024, 3) and pool["is_aligned"] is False
    b1 = ttd.pool_batch(pool, 1)
    assert b1["src_fds"].data_ptr() == pool["src_fds"][1].data_ptr()
    _equal_batches({k: v.numpy() for k, v in b1.items() if k != "is_aligned"},
                   {k: v for k, v in host[1].items() if k != "is_aligned"})
    bad = dict(host[0], is_aligned=np.asarray(True))
    with pytest.raises(ValueError):
        ttd.stack_batches([host[0], bad], "cpu")
