"""Visualization export utilities.

The port's own copy of :mod:`bufferx_tpu.utils.vis`. The reference ships
Open3D-window helpers (``utils/common.py:569-706``:
``make_open3d_point_cloud``, ``plot_corres``, ``plot_correspondences``).
Headless hosts have no display, so these export the same artifacts as
standard PLY files instead: colored clouds and correspondence line sets,
viewable in any point-cloud tool. Inputs are numpy arrays or tensors (a
card tensor is copied to the host).
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["save_ply", "save_correspondences_ply", "export_registration"]


def _host(x):
    """A tensor (on any device) as a numpy array; anything else as is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def save_ply(path: str, points: np.ndarray, color=None) -> str:
    """Writes [N, 3] points (optional [3] or [N, 3] uint8-able color)."""
    points = np.asarray(_host(points), np.float32)
    n = len(points)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % n)
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        if color is not None:
            f.write(
                b"property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write(b"end_header\n")
        if color is None:
            f.write(points.astype("<f4").tobytes())
        else:
            c = np.asarray(_host(color))
            if c.ndim == 1:
                c = np.tile(c, (n, 1))
            c = np.clip(c * 255 if c.max() <= 1.0 else c, 0, 255).astype(np.uint8)
            rec = np.zeros(
                n,
                dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("r", "u1"), ("g", "u1"), ("b", "u1")],
            )
            rec["x"], rec["y"], rec["z"] = points.T
            rec["r"], rec["g"], rec["b"] = c.T
            f.write(rec.tobytes())
    return path


def save_correspondences_ply(
    path: str,
    src_kpts: np.ndarray,
    tgt_kpts: np.ndarray,
    inlier_mask: np.ndarray | None = None,
    offset=(0.0, 0.0, 2.0),
) -> str:
    """Correspondence line set (reference ``plot_correspondences``):
    target shifted by ``offset``; inliers green, outliers red."""
    src = np.asarray(_host(src_kpts), np.float32)
    tgt = np.asarray(_host(tgt_kpts), np.float32) + np.asarray(offset,
                                                               np.float32)
    n = len(src)
    if inlier_mask is None:
        inlier_mask = np.ones(n, bool)
    verts = np.concatenate([src, tgt])
    colors = np.where(
        np.asarray(_host(inlier_mask))[:, None], [0, 255, 0], [255, 0, 0]
    ).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % (2 * n))
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"element edge %d\n" % n)
        f.write(b"property int vertex1\nproperty int vertex2\n")
        f.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(b"end_header\n")
        f.write(verts.astype("<f4").tobytes())
        rec = np.zeros(
            n,
            dtype=[("a", "<i4"), ("b", "<i4"),
                   ("r", "u1"), ("g", "u1"), ("b3", "u1")],
        )
        rec["a"] = np.arange(n)
        rec["b"] = np.arange(n) + n
        rec["r"], rec["g"], rec["b3"] = colors.T
        f.write(rec.tobytes())
    return path


def export_registration(
    out_dir: str,
    src_points: np.ndarray,
    tgt_points: np.ndarray,
    pose: np.ndarray,
    src_kpts: np.ndarray | None = None,
    tgt_kpts: np.ndarray | None = None,
    inlier_mask: np.ndarray | None = None,
) -> str:
    """One-call debugging export (reference ``plot_corres`` equivalent):
    source (gold), aligned source (blue), target (gray), correspondences."""
    save_ply(os.path.join(out_dir, "src.ply"), src_points, [227, 207, 87])
    save_ply(os.path.join(out_dir, "tgt.ply"), tgt_points, [128, 128, 128])
    src_points = _host(src_points)
    pose = np.asarray(_host(pose))
    aligned = src_points @ pose[:3, :3].T + pose[:3, 3]
    save_ply(os.path.join(out_dir, "src_aligned.ply"), aligned, [0, 166, 237])
    if src_kpts is not None and tgt_kpts is not None:
        save_correspondences_ply(
            os.path.join(out_dir, "correspondences.ply"),
            src_kpts, tgt_kpts, inlier_mask,
        )
    return out_dir
