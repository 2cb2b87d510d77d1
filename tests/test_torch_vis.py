"""Port parity of the visualization writers (``bufferx_tpu_torch/utils/
vis.py``) against ``bufferx_tpu/utils/vis.py``: every writer's bytes are
equal for the same inputs (numpy arrays, or tensors for the port), and
``data/io.py:save_ply`` still writes the colourless writer's bytes."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins the CPU)
from bufferx_tpu.utils import vis as jv
from bufferx_tpu_torch.data import io as tio
from bufferx_tpu_torch.utils import vis as tv


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.mark.parametrize("color", [None, [227, 207, 87], [0.1, 0.5, 1.0],
                                   "per_point_u8", "per_point_unit"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_save_ply(tmp_path, color, as_tensor):
    rs = np.random.RandomState(0)
    pts = rs.randn(57, 3).astype(np.float32)
    if color == "per_point_u8":
        color = rs.randint(0, 256, (57, 3))
    elif color == "per_point_unit":
        color = rs.rand(57, 3)
    jv.save_ply(str(tmp_path / "j.ply"), pts, color)
    arg = torch.from_numpy(pts) if as_tensor else pts
    tv.save_ply(str(tmp_path / "t" / "p.ply"), arg, color)
    assert _read(tmp_path / "t" / "p.ply") == _read(tmp_path / "j.ply")


def test_colourless_io_writer_unchanged(tmp_path):
    pts = np.random.RandomState(1).randn(40, 3)
    jv.save_ply(str(tmp_path / "j.ply"), pts)
    tio.save_ply(str(tmp_path / "io.ply"), pts)
    assert _read(tmp_path / "io.ply") == _read(tmp_path / "j.ply")


@pytest.mark.parametrize("mask", [None, "random"])
def test_save_correspondences_ply(tmp_path, mask):
    rs = np.random.RandomState(2)
    s, t = rs.randn(30, 3), rs.randn(30, 3)
    m = None if mask is None else rs.rand(30) > 0.4
    jv.save_correspondences_ply(str(tmp_path / "j.ply"), s, t, m)
    tv.save_correspondences_ply(str(tmp_path / "t.ply"), torch.from_numpy(s),
                                t, None if m is None else torch.from_numpy(m),
                                offset=(0.0, 0.0, 2.0))
    assert _read(tmp_path / "t.ply") == _read(tmp_path / "j.ply")


@pytest.mark.parametrize("with_kpts", [False, True])
def test_export_registration(tmp_path, with_kpts):
    rs = np.random.RandomState(3)
    src, tgt = rs.randn(100, 3).astype(np.float32), rs.randn(80, 3)
    pose = np.eye(4)
    pose[:3, 3] = [0.1, -0.2, 0.3]
    kw = {}
    if with_kpts:
        kw = dict(src_kpts=rs.randn(12, 3), tgt_kpts=rs.randn(12, 3),
                  inlier_mask=rs.rand(12) > 0.5)
    jv.export_registration(str(tmp_path / "j"), src, tgt, pose, **kw)
    tv.export_registration(str(tmp_path / "t"), src, tgt,
                           torch.from_numpy(pose), **kw)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert ("correspondences.ply" in names) == with_kpts
    for n in names:
        assert _read(tmp_path / "t" / n) == _read(tmp_path / "j" / n), n
