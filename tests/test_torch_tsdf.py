"""Port parity of the TSDF fusion (``bufferx_tpu_torch/tools/tsdf.py``)
against ``bufferx_tpu/tools/tsdf.py`` on the same seeded frames.

The three cases of ``tests/test_tools.py``, seeded tilted and translated
frames, and a camera pitched 90 degrees whose voxels project onto pixel
centres, onto pixel edges (half-integers, rounded half to even by both)
and onto ``diff = -trunc`` exactly. The port rounds as XLA's CPU code
does (its fused multiply-adds emulated in float64, its dot's summation
order kept), so tsdf, weight and the extracted points are held equal to
the bit, in ``np.argwhere`` order. The flat-wall cases put whole voxel
layers exactly on the surface band |tsdf| = 0.2, where one ulp flips a
layer: they hold the rounding, not only the formula.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins the CPU)
from bufferx_tpu.tools import tsdf as jt
from bufferx_tpu_torch.tools import tsdf as tt

def both(origin, dims, voxel, frames, trunc=None):
    """Fuse ``frames`` ([(K, cam2base, depth)]) in both packages; returns
    (JAX volume, port volume)."""
    vj = jt.make_volume(origin, dims, voxel, trunc)
    vt = tt.make_volume(origin, dims, voxel, trunc, device="cpu")
    for k, pose, depth in frames:
        vj = jt.integrate_frame(vj, k, pose, depth)
        vt = tt.integrate_frame(vt, k, pose, depth)
    return vj, vt


def assert_close(vj, vt):
    """Volumes equal to the bit, extracted points equal in order; returns
    the points."""
    np.testing.assert_array_equal(vt.weight.numpy(), np.asarray(vj.weight))
    np.testing.assert_array_equal(vt.tsdf.numpy(), np.asarray(vj.tsdf))
    pj, pt = jt.extract_points(vj), tt.extract_points(vt)
    assert pt.dtype == np.float32
    np.testing.assert_array_equal(pt, pj)
    return pj


def test_flat_wall_reconstruction():
    h, w = 64, 64
    k = np.array([[64.0, 0, w / 2], [0, 64.0, h / 2], [0, 0, 1]], np.float32)
    depth = np.full((h, w), 1.0, np.float32)
    vj, vt = both([-0.6, -0.6, 0.4], (48, 48, 32), 0.025,
                  [(k, np.eye(4, dtype=np.float32), depth)])
    pts = assert_close(vj, vt)
    assert len(pts) > 50
    assert abs(np.median(tt.extract_points(vt)[:, 2]) - 1.0) < 0.05


def test_two_views_merge():
    h, w = 48, 48
    k = np.array([[48.0, 0, 24], [0, 48.0, 24], [0, 0, 1]], np.float32)
    depth = np.full((h, w), 1.0, np.float32)
    c2 = np.eye(4, dtype=np.float32)
    c2[0, 3] = 0.3
    vj, vt = both([-0.8, -0.8, 0.3], (64, 64, 40), 0.025,
                  [(k, np.eye(4, dtype=np.float32), depth), (k, c2, depth)])
    assert_close(vj, vt)
    assert tt.extract_points(vt)[:, 0].max() > 0.5
    assert float(vt.weight.max()) >= 2.0


def test_invalid_depth_ignored():
    h, w = 32, 32
    k = np.array([[32.0, 0, 16], [0, 32.0, 16], [0, 0, 1]], np.float32)
    vj, vt = both([-0.5, -0.5, 0.5], (16, 16, 16), 0.05,
                  [(k, np.eye(4, dtype=np.float32),
                    np.zeros((h, w), np.float32))])
    assert_close(vj, vt)
    assert float(vt.weight.abs().max()) == 0.0
    assert torch.equal(vt.tsdf, torch.ones_like(vt.tsdf))


def test_tilted_camera_on_pixel_centres_edges_and_truncation():
    """Camera pitched 90 degrees (its y along the base z, its z along the
    base -y) and translated: every voxel centre, camera coordinate and
    projection is a dyadic rational, so both packages agree to the bit.
    Voxels land on pixel centres (integer u), on pixel edges (u = n + 1/2:
    half to even) and, at truncation 0.625, on diff = -trunc exactly (not
    fused) beside diff = -trunc + 1/8 (fused)."""
    h, w = 32, 40
    k = np.array([[4.0, 0, 20.0], [0, 4.0, 16.0], [0, 0, 1]], np.float32)
    pose = np.array([[1, 0, 0, 0.5],
                     [0, 0, -1, 0.75],
                     [0, 1, 0, 0.75],
                     [0, 0, 0, 1]], np.float32)
    rs = np.random.RandomState(3)
    depth = rs.choice(np.float32([0.0, 0.375, 0.5, 1.0, 1.5]), (h, w))
    vj, vt = both([-1.0, -1.0, -1.0], (24, 24, 24), 0.125,
                  [(k, pose, depth)], trunc=0.625)
    # the cases occur: the projections in float64 (exact here)
    g = np.arange(24) * 0.125 - 1.0
    p = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1)
    cam = (p - pose[:3, 3]) @ pose[:3, :3].astype(np.float64)
    zc = cam[..., 2]
    front = zc > 0
    u = np.where(front, 4.0 * cam[..., 0] / np.where(front, zc, 1) + 20, -1)
    v = np.where(front, 4.0 * cam[..., 1] / np.where(front, zc, 1) + 16, -1)
    ur, vr = np.round(u), np.round(v)                 # half to even
    inside = front & (ur >= 0) & (ur < w) & (vr >= 0) & (vr < h)
    d = depth[np.clip(vr, 0, h - 1).astype(int), np.clip(ur, 0, w - 1)
              .astype(int)]
    assert (inside & (u == ur)).any()                        # centres
    assert (inside & (u - np.floor(u) == 0.5)).any()         # edges
    assert (inside & (d > 0) & (d - zc == -0.625)).any()     # -trunc
    assert (inside & (d > 0) & (d - zc == -0.5)).any()
    pts = assert_close(vj, vt)
    assert len(pts) > 0 and float(vt.weight.max()) == 1.0


def test_reset_and_in_place():
    """integrate_frame updates the volume's own tensors; reset_volume
    empties them for the next fragment."""
    k = np.array([[32.0, 0, 16], [0, 32.0, 16], [0, 0, 1]], np.float32)
    vt = tt.make_volume([-0.5, -0.5, 0.5], (16, 16, 16), 0.05, device="cpu")
    ptr = vt.tsdf.data_ptr()
    out = tt.integrate_frame(vt, k, np.eye(4), np.full((32, 32), 1.0))
    assert out.tsdf.data_ptr() == ptr and float(vt.weight.max()) == 1.0
    tt.reset_volume(vt)
    assert float(vt.weight.abs().max()) == 0.0
    assert torch.equal(vt.tsdf, torch.ones_like(vt.tsdf))


def test_card_volume_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        tt.make_volume([0, 0, 0], (4, 4, 4), 0.1)


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_frames(seed):
    """Five tilted, translated frames of a noisy depth image."""
    from scipy.spatial.transform import Rotation

    rs = np.random.RandomState(seed)
    h, w = 48, 64
    k = np.array([[60.0, 0, 31.7], [0, 58.0, 23.9], [0, 0, 1]])
    frames = []
    for _ in range(5):
        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_rotvec(rs.uniform(-0.2, 0.2, 3)
                                            ).as_matrix()
        pose[:3, 3] = rs.uniform(-0.1, 0.1, 3)
        depth = (1.0 + 0.3 * rs.rand(h, w)).astype(np.float32)
        depth[rs.rand(h, w) < 0.1] = 0
        frames.append((k, pose, depth))
    vj, vt = both([-0.8, -0.7, 0.3], (64, 60, 50), 0.025, frames)
    assert_close(vj, vt)
