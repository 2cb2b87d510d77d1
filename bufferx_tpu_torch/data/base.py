"""Dataset base machinery: trajectory logs, pair enumeration, preprocessing.

The port's own copy of :mod:`bufferx_tpu.data.base` (numpy only).

All 13 loaders share one template (SURVEY §2.5): enumerate pairs (gt.log for
fragment datasets, odometry-distance walking for LiDAR sequences) -> load
raw clouds -> sphericity-based adaptive voxel downsample (test) or fixed
(train) -> optional augmentation -> cap at ``max_num_pts`` -> sample dict:

    {"src_points", "tgt_points", "relt_pose", "src_id", "tgt_id",
     "voxel_size", "sphericity", "is_aligned_to_global_z", "dataset_name"}

(The fds/sds split of the reference happens later: fds == src/tgt_points
here; sds is recomputed where the training batch is assembled.)
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from bufferx_tpu_torch.config import Config
from bufferx_tpu_torch.data.io import read_points
from bufferx_tpu_torch.geometry.sphericity import sphericity_based_voxel_analysis
from bufferx_tpu_torch.kernels.voxel import voxel_downsample_np

__all__ = [
    "read_trajectory_log",
    "write_trajectory_log",
    "read_trajectory_info",
    "walk_odometry_pairs",
    "compute_overlap_ratio",
    "PairDataset",
]


def read_trajectory_log(path: str, dim: int = 4):
    """Parses a 3DMatch-style trajectory ``.log``: blocks of one metadata
    line (i, j, num_fragments) + a 4x4 matrix. Returns (pairs [M, 3] int,
    poses [M, 4, 4]) — reference ``utils/tools.py:49-94`` semantics."""
    pairs, poses = [], []
    with open(path) as f:
        lines = [ln for ln in (l.strip() for l in f) if ln]
    i = 0
    while i < len(lines):
        meta = lines[i].split()
        pairs.append([int(meta[0]), int(meta[1]), int(meta[2])])
        mat = [list(map(float, lines[i + 1 + r].split())) for r in range(dim)]
        poses.append(np.asarray(mat, np.float64))
        i += 1 + dim
    return np.asarray(pairs, np.int64), np.stack(poses) if poses else np.zeros((0, 4, 4))


def write_trajectory_log(path: str, pairs, poses) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for (i, j, n), T in zip(pairs, poses):
            f.write(f"{int(i)}\t{int(j)}\t{int(n)}\n")
            for r in range(4):
                f.write("\t".join(f"{v:.8e}" for v in np.asarray(T)[r]) + "\n")
    return path


def read_trajectory_info(path: str, dim: int = 6):
    """Parses ``gt.info``: per-pair 6x6 information matrices
    (reference ``utils/tools.py:72-94``)."""
    pairs, infos = [], []
    with open(path) as f:
        lines = [ln for ln in (l.strip() for l in f) if ln]
    i = 0
    while i < len(lines):
        meta = lines[i].split()
        pairs.append([int(meta[0]), int(meta[1]), int(meta[2])])
        mat = [list(map(float, lines[i + 1 + r].split())) for r in range(dim)]
        infos.append(np.asarray(mat, np.float64))
        i += 1 + dim
    return np.asarray(pairs, np.int64), (
        np.stack(infos) if infos else np.zeros((0, dim, dim))
    )


def walk_odometry_pairs(
    positions: np.ndarray, pdist: float, exclude: Sequence[tuple] = ()
) -> List[tuple]:
    """LiDAR pair enumeration: walk the trajectory emitting (i, j) whenever
    the accumulated translation exceeds ``pdist`` meters (reference
    ``dataset/kitti.py:33-63``). ``exclude`` lists known-bad (i, j)
    frame-index pairs to drop from the walk (reference ``kitti.py:60-61``
    removes pair (drive 8, 15, 58))."""
    pairs = []
    excluded = {(int(a), int(b)) for a, b in exclude}
    n = len(positions)
    i = 0
    while i < n - 1:
        j = i + 1
        while j < n and np.linalg.norm(positions[j] - positions[i]) < pdist:
            j += 1
        if j >= n:
            break
        if (i, j) not in excluded:
            pairs.append((i, j))
        i = j
    return pairs


def compute_overlap_ratio(
    src: np.ndarray, tgt: np.ndarray, relt_pose: np.ndarray,
    voxel_size: float,
):
    """Bidirectional overlap fractions at a voxel scale (reference
    ``utils/tools.py:217-225``): fraction of downsampled points with a
    within-voxel neighbor in the other (pose-aligned) cloud."""
    from scipy.spatial import cKDTree

    s = voxel_downsample_np(np.asarray(src, np.float32), voxel_size)
    t = voxel_downsample_np(np.asarray(tgt, np.float32), voxel_size)
    T = np.asarray(relt_pose)
    s_warp = s @ T[:3, :3].T + T[:3, 3]
    d0, _ = cKDTree(t).query(s_warp)
    d1, _ = cKDTree(s_warp).query(t)
    return float((d0 < voxel_size).mean()), float((d1 < voxel_size).mean())


class PairDataset:
    """Shared loader template. Subclasses (or instances) provide:

    - ``self.pairs``: list of opaque pair descriptors
    - ``self.load_pair(desc) -> (src_raw, tgt_raw, relt_pose, src_id,
      tgt_id, extra_dict)``
    """

    def __init__(self, cfg: Config, split: str = "test"):
        self.cfg = cfg
        self.split = split
        self.pairs: list = []
        self.rng = np.random.RandomState(cfg.data.manual_seed)

    # -- subclass hooks -------------------------------------------------
    def load_pair(self, desc):
        raise NotImplementedError

    # -- template -------------------------------------------------------
    def __len__(self):
        return len(self.pairs)

    def preprocess(self, src_raw, tgt_raw):
        """Adaptive (test) voxel downsampling + max-point cap."""
        cfg = self.cfg
        if self.split == "test":
            voxel, sph, _pca_aligned = sphericity_based_voxel_analysis(
                src_raw, tgt_raw, self.rng
            )
        else:
            voxel, sph = cfg.data.downsample, 0.0
        # the reference discards the PCA alignment verdict and uses the
        # config profile's flag (dataset/threedmatch.py:83-86,
        # kitti.py:123-126) — outdoor datasets assert gravity alignment
        aligned = cfg.patch.is_aligned_to_global_z
        src = voxel_downsample_np(src_raw, voxel)
        tgt = voxel_downsample_np(tgt_raw, voxel)
        cap = cfg.data.max_num_pts
        if len(src) > cap:
            src = src[self.rng.choice(len(src), cap, replace=False)]
        if len(tgt) > cap:
            tgt = tgt[self.rng.choice(len(tgt), cap, replace=False)]
        return src, tgt, voxel, sph, aligned

    def __getitem__(self, idx: int) -> dict:
        desc = self.pairs[idx]
        src_raw, tgt_raw, pose, src_id, tgt_id, extra = self.load_pair(desc)
        src, tgt, voxel, sph, aligned = self.preprocess(src_raw, tgt_raw)
        sample = dict(
            src_points=src.astype(np.float32),
            tgt_points=tgt.astype(np.float32),
            relt_pose=np.asarray(pose, np.float32),
            src_id=src_id,
            tgt_id=tgt_id,
            voxel_size=voxel,
            sphericity=sph,
            is_aligned_to_global_z=bool(aligned),
            dataset_name=self.cfg.data.dataset,
        )
        sample.update(extra)
        return sample

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    @staticmethod
    def _read(path: str) -> np.ndarray:
        return read_points(path)
