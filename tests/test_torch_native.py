"""Port parity of the native host library (``bufferx_tpu_torch/native.py``
over its own copy of the C++ source) against the JAX package's binding
(``bufferx_tpu/native.py`` over ``native/libbufferx_native.so``) and the
numpy oracles of ``tests/test_native.py``: the same inputs give equal
outputs. The port builds into ``bufferx_tpu_torch/_build/`` with the host
compiler and leaves ``native/`` byte-unchanged; a build that fails raises
instead of falling back."""

import hashlib
import os

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins the CPU)
from bufferx_tpu import native as jn
from bufferx_tpu.kernels.voxel import voxel_downsample_np
from bufferx_tpu_torch import native as tn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "native")


def _digest(d):
    h = {}
    for n in sorted(os.listdir(d)):
        with open(os.path.join(d, n), "rb") as f:
            h[n] = hashlib.sha256(f.read()).hexdigest()
    return h


@pytest.fixture(scope="module", autouse=True)
def built():
    before = _digest(NATIVE)
    assert tn.build(), "the port's host library did not build"
    assert tn.available() and jn.available()
    assert _digest(NATIVE) == before
    assert os.path.dirname(tn.lib_path()) == os.path.join(
        ROOT, "bufferx_tpu_torch", "_build")


def test_fresh_build_leaves_native_unchanged(tmp_path, monkeypatch):
    """A build from scratch (into an empty build directory) writes only
    there: every file under ``native/`` keeps its bytes."""
    before = _digest(NATIVE)
    monkeypatch.setattr(tn, "_BUILD", str(tmp_path / "_build"))
    monkeypatch.setattr(tn, "_lib", None)
    pts = np.random.RandomState(0).randn(300, 3).astype(np.float32)
    out = tn.fps(pts, 8)
    assert os.listdir(tmp_path / "_build") == [
        os.path.basename(tn.lib_path())]
    np.testing.assert_array_equal(out, jn.fps(pts, 8))
    assert _digest(NATIVE) == before


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(tn, "_BUILD", str(tmp_path / "_build"))
    monkeypatch.setattr(tn, "_lib", None)
    assert not tn.available()
    assert not tn.build()
    with pytest.raises(RuntimeError, match="host library"):
        tn.voxel_downsample(np.zeros((4, 3), np.float32), 0.1)


@pytest.mark.parametrize("voxel,capacity", [(0.4, None), (0.05, None),
                                            (0.01, 64)])
def test_voxel_downsample(rng, voxel, capacity):
    pts = (rng.randn(5000, 3) * (40 if capacity else 1)).astype(np.float32)
    got = tn.voxel_downsample(pts, voxel, capacity=capacity)
    np.testing.assert_array_equal(got, jn.voxel_downsample(
        pts, voxel, capacity=capacity))
    if capacity:
        assert len(got) == capacity
        return
    want = voxel_downsample_np(pts, voxel)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[np.lexsort(got.T)],
                               want[np.lexsort(want.T)], atol=1e-4)


@pytest.mark.parametrize("radius,max_count", [(0.5, 64), (0.6, 500)])
def test_radius_neighbors(rng, radius, max_count):
    pts = rng.randn(1500, 3).astype(np.float32)
    q = pts[:16]
    idx = tn.radius_neighbors(q, pts, radius, max_count)
    np.testing.assert_array_equal(idx, jn.radius_neighbors(q, pts, radius,
                                                           max_count))
    d2 = ((q[:, None] - pts[None]) ** 2).sum(-1)
    for i in range(16):
        hits = idx[i][idx[i] >= 0]
        assert np.all(d2[i, hits] <= radius * radius + 1e-5)
        assert len(hits) == min(int((d2[i] <= radius * radius).sum()),
                                max_count)


@pytest.mark.parametrize("k,cell", [(5, None), (9, 0.3)])
def test_knn(rng, k, cell):
    pts = rng.randn(3000, 3).astype(np.float32)
    q = rng.randn(32, 3).astype(np.float32)
    idx, d2 = tn.knn(q, pts, k, cell_size=cell)
    jidx, jd2 = jn.knn(q, pts, k, cell_size=cell)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(d2, jd2)
    if cell is not None:      # a given cell size bounds the search: both
        return                # libraries agree, brute force may not
    bf = ((q[:, None] - pts[None]) ** 2).sum(-1)
    bf_d = np.take_along_axis(bf, np.argsort(bf, axis=1)[:, :k], 1)
    np.testing.assert_allclose(np.sort(d2, 1), np.sort(bf_d, 1), rtol=1e-4)


def test_fps(rng):
    pts = rng.randn(800, 3).astype(np.float32)
    got = tn.fps(pts, 32)
    np.testing.assert_array_equal(got, jn.fps(pts, 32))
    sel = [0]
    mind = ((pts - pts[0]) ** 2).sum(-1)
    for _ in range(31):
        s = int(np.argmax(mind))
        sel.append(s)
        mind = np.minimum(mind, ((pts - pts[s]) ** 2).sum(-1))
    np.testing.assert_array_equal(got, sel)
