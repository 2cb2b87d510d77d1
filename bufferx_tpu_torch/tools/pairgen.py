"""Offline pair-dataset synthesis tools.

The port's own copy of :mod:`bufferx_tpu.tools.pairgen` (numpy only: it
runs no device code).

- :func:`process_modelnet40`: random SE(3) + half-space-crop pair synthesis
  from object clouds, written as the on-disk layout
  ``<out>/<object>/{gt.log, cloud_bin_N.npy}`` that
  :class:`bufferx_tpu_torch.data.datasets.ModelNet40Dataset` consumes (the
  reference's ``dataset/modelnet40/process_modelnet40.py:11-45``).
- :func:`decompose_to_scans`: simulated-scanner decomposition of an aligned
  cloud into partial views by visibility sectors around virtual scan
  positions (the Faro-style preprocessing,
  ``dataset/scannetpp/faro/decompose_aligned_pointcloud.py``).
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np

from bufferx_tpu_torch.data.base import write_trajectory_log
from bufferx_tpu_torch.data.modelnet import (
    make_pair_from_points,
    synthetic_object,
)

__all__ = ["process_modelnet40", "decompose_to_scans"]


def process_modelnet40(
    out_dir: str,
    num_objects: int = 10,
    pairs_per_object: int = 2,
    num_points: int = 8192,
    overlap: float = 0.7,
    seed: int = 0,
    objects: list | None = None,
    names: list | None = None,
) -> str:
    """Synthesizes a ModelNet40-style pair benchmark on disk.

    ``objects``: optional list of [N, 3] arrays (real ModelNet meshes
    sampled to points); procedural objects otherwise. ``names``: optional
    per-object scene names — when sampling real ModelNet40 shapes, pass
    ``f"{category}_{id}"`` with categories drawn from the PINNED held-out
    half (``bufferx_tpu_torch.data.splits.MODELNET40_HALF2_CATEGORIES``,
    reference ``config/splits/modelnet40_half2.txt``) so the benchmark
    matches the reference's zero-shot category split.
    """
    rs = np.random.RandomState(seed)
    for oi in range(num_objects):
        obj = (
            objects[oi]
            if objects is not None
            else synthetic_object(rs, num_points)
        )
        name = names[oi] if names is not None else f"object_{oi:04d}"
        scene = join(out_dir, name)
        os.makedirs(scene, exist_ok=True)
        pairs, poses = [], []
        for pi in range(pairs_per_object):
            src, tgt, T = make_pair_from_points(obj, rs, overlap=overlap)
            a, b = 2 * pi, 2 * pi + 1
            np.save(join(scene, f"cloud_bin_{a}.npy"), src)
            np.save(join(scene, f"cloud_bin_{b}.npy"), tgt)
            # loader convention: relt_pose = inv(log pose)
            pairs.append([a, b, 2 * pairs_per_object])
            poses.append(np.linalg.inv(T))
        write_trajectory_log(join(scene, "gt.log"), pairs, poses)
    return out_dir


def decompose_to_scans(
    cloud: np.ndarray,
    num_scans: int = 4,
    fov_deg: float = 360.0,
    max_range: float = 50.0,
    seed: int = 0,
):
    """Splits an aligned cloud into ``num_scans`` partial views.

    Virtual scanners are placed inside the cloud's bounding box; each scan
    keeps the points visible from its position (range + angular occlusion
    test on a coarse spherical bin grid — nearest return per bin wins, like
    a scanner). Returns (scans, positions).
    """
    rs = np.random.RandomState(seed)
    lo, hi = cloud.min(0), cloud.max(0)
    center = (lo + hi) / 2
    span = hi - lo
    scans, positions = [], []
    for _ in range(num_scans):
        pos = center + (rs.rand(3) - 0.5) * span * 0.5
        rel = cloud - pos
        rng = np.linalg.norm(rel, axis=-1)
        az = np.arctan2(rel[:, 1], rel[:, 0])
        el = np.arcsin(np.clip(rel[:, 2] / np.maximum(rng, 1e-9), -1, 1))
        az_bin = ((az + np.pi) / (2 * np.pi) * 512).astype(int) % 512
        el_bin = np.clip(((el + np.pi / 2) / np.pi * 128).astype(int), 0, 127)
        bins = az_bin * 128 + el_bin
        visible = np.zeros(len(cloud), bool)
        order = np.argsort(rng)
        seen = np.zeros(512 * 128, bool)
        for i in order:
            if rng[i] > max_range:
                break
            b = bins[i]
            if not seen[b]:
                seen[b] = True
                visible[i] = True
        # occlusion tolerance: also keep points within 2% range of the first
        # return in their bin (surfaces are not infinitely thin)
        first_range = np.full(512 * 128, np.inf)
        np.minimum.at(first_range, bins, rng)
        near_first = rng <= first_range[bins] * 1.02
        visible |= near_first & (rng <= max_range)
        scans.append(cloud[visible].astype(np.float32))
        positions.append(pos.astype(np.float32))
    return scans, positions
