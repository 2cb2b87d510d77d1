"""Port parity of the pair synthesis (``bufferx_tpu_torch/tools/pairgen.py``)
against ``bufferx_tpu/tools/pairgen.py``: the same seeds give byte-equal
layouts (``gt.log`` and every ``cloud_bin_N.npy``) and equal scans, and the
port's layout loads through its ``ModelNet40Dataset``."""

import os

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins the CPU)
from bufferx_tpu.data.modelnet import synthetic_object
from bufferx_tpu.tools import pairgen as jp
from bufferx_tpu_torch.tools import pairgen as tp


def _files(root):
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("kw", [
    dict(num_objects=2, pairs_per_object=2, num_points=1500),
    dict(num_objects=1, pairs_per_object=1, num_points=800, overlap=0.5,
         seed=3, names=["chair_0001"]),
], ids=["procedural", "named"])
def test_process_modelnet40_byte_equal(tmp_path, kw):
    jp.process_modelnet40(str(tmp_path / "jax"), **kw)
    tp.process_modelnet40(str(tmp_path / "port"), **kw)
    fj, fp = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(fp) == sorted(fj) and fj
    for k in fj:
        assert fp[k] == fj[k], k


def test_process_modelnet40_given_objects(tmp_path):
    objs = [synthetic_object(np.random.RandomState(i), 1200) * 2
            for i in range(2)]
    jp.process_modelnet40(str(tmp_path / "jax"), num_objects=2,
                          pairs_per_object=1, objects=objs)
    tp.process_modelnet40(str(tmp_path / "port"), num_objects=2,
                          pairs_per_object=1, objects=objs)
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")


def test_layout_loads_through_the_ports_dataset(tmp_path):
    from bufferx_tpu_torch.config import make_cfg
    from bufferx_tpu_torch.data.datasets import ModelNet40Dataset

    out = tp.process_modelnet40(str(tmp_path / "mn40"), num_objects=2,
                                pairs_per_object=1, num_points=2000)
    ds = ModelNet40Dataset(make_cfg("ModelNet40", out))
    assert len(ds) == 2
    s = ds[0]
    src, tgt, T = s["src_points"], s["tgt_points"], s["relt_pose"]
    from scipy.spatial import cKDTree

    d, _ = cKDTree(tgt).query(src @ T[:3, :3].T + T[:3, 3])
    assert np.median(d) < 0.05


@pytest.mark.parametrize("num_scans,seed,max_range", [(3, 1, 50.0),
                                                      (2, 4, 2.5)])
def test_decompose_to_scans_equal(num_scans, seed, max_range):
    cloud = synthetic_object(np.random.RandomState(0), 5000) * 3
    sj, pj = jp.decompose_to_scans(cloud, num_scans=num_scans, seed=seed,
                                   max_range=max_range)
    st, pt = tp.decompose_to_scans(cloud, num_scans=num_scans, seed=seed,
                                   max_range=max_range)
    assert len(st) == len(sj) == num_scans
    for a, b in zip(st + pt, sj + pj):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert all(0 < len(s) < len(cloud) for s in st)
