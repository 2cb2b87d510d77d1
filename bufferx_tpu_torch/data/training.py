"""Training batch assembly (host numpy -> fixed-shape batches).

Counterpart of :mod:`bufferx_tpu.data.training`: two downsampling levels
(fds for the patches, sds for the supervision keypoints), cloud-level
rotation augmentation with the ground truth conjugated, jitter, padding to
``capacity.max_points``, ground-truth correspondences and a randomized
descriptor radius. With ``host_arrays=True`` everything stays numpy (the
correspondences from a KD-tree on the host), bit for bit the JAX package's
arrays for the same ``RandomState``, so that a pool of batches can be built
on the host and shipped to the card in one copy (:func:`stack_batches`,
:func:`to_device`). Otherwise the correspondences are sampled on the device
by :func:`~bufferx_tpu_torch.train.forward.sample_gt_correspondences`.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from bufferx_tpu_torch.config import Config
from bufferx_tpu_torch.data.modelnet import synthetic_pair
from bufferx_tpu_torch.device import resolve_device
from bufferx_tpu_torch.kernels.voxel import voxel_downsample_np
from bufferx_tpu_torch.train.forward import sample_gt_correspondences

__all__ = [
    "build_training_batch",
    "synthetic_training_stream",
    "random_des_r",
    "rotate_pair",
    "to_device",
    "stack_batches",
    "pool_batch",
]


def _pad(xyz: np.ndarray, cap: int, rs: np.random.RandomState):
    xyz = np.asarray(xyz, np.float32)
    if len(xyz) > cap:
        xyz = xyz[rs.choice(len(xyz), cap, replace=False)]
    else:
        xyz = xyz[rs.permutation(len(xyz))]
    out = np.zeros((cap, 3), np.float32)
    out[: len(xyz)] = xyz
    mask = np.zeros(cap, bool)
    mask[: len(xyz)] = True
    return out, mask


def _random_rotation(rs: np.random.RandomState, mode: str) -> np.ndarray:
    """A uniform random rotation: about +z ("so2") or in SO(3)."""
    if mode == "so2":
        th = rs.uniform(0.0, 2.0 * np.pi)
        c, s = np.cos(th), np.sin(th)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                        np.float32)
    q = rs.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def rotate_pair(src_pts: np.ndarray, tgt_pts: np.ndarray,
                gt_pose: np.ndarray, rs: np.random.RandomState, mode: str):
    """Independent random rotations of the two clouds ("so3", "so2" or
    "none"), each also pushed off the origin by ~3x its bounding radius (the
    sensor-frame geometry that keeps the LRF's normal-sign choice stable
    under rotation), with the ground truth conjugated: src' = Rs src + ds,
    tgt' = Rt tgt + dt, R' = Rt R Rs^T, t' = Rt t + dt - R' ds."""
    if mode == "none":
        return src_pts, tgt_pts, np.asarray(gt_pose, np.float32)
    Rs = _random_rotation(rs, mode)
    Rt = _random_rotation(rs, mode)

    def offset(pts):
        rad = float(np.linalg.norm(pts, axis=1).max()) + 1e-6
        d = rs.randn(3)
        if mode == "so2":
            d[2] = abs(d[2])        # a gravity-consistent viewpoint shift
        d /= np.linalg.norm(d) + 1e-12
        return (d * rad * (2.5 + rs.uniform(0.0, 1.0))).astype(np.float32)

    ds, dt = offset(src_pts), offset(tgt_pts)
    T = np.asarray(gt_pose, np.float32)
    R, t = T[:3, :3], T[:3, 3]
    Rp = Rt @ R @ Rs.T
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = Rp
    out[:3, 3] = Rt @ t + dt - Rp @ ds
    return ((src_pts @ Rs.T + ds).astype(np.float32),
            (tgt_pts @ Rt.T + dt).astype(np.float32), out)


def random_des_r(cfg: Config, rs: np.random.RandomState) -> float:
    """Randomized training radius: KITTI's discrete choices, otherwise a
    gaussian about the centre radius clipped to [0.5, 1.5]x it."""
    center = cfg.patch.des_r
    if cfg.data.dataset == "KITTI":
        if center == 3.0:
            return float(rs.choice([2.0, 2.5, 3.0, 3.5, 4.0]))
        if center == 0.3:
            return float(rs.choice([0.2, 0.25, 0.3, 0.35, 0.4]))
    lo, hi = center * 0.5, center * 1.5
    std = (hi - lo) / 6.0
    return float(np.round(np.clip(rs.normal(center, std), lo, hi), 2))


def _host_gt_correspondences(src_sds_p, src_sds_m, tgt_sds_p, tgt_sds_m,
                             gt_pose, voxel_size,
                             rs: np.random.RandomState, pos_num: int):
    """Host twin of ``sample_gt_correspondences``: the same distribution,
    through a KD-tree and ``rs``."""
    from scipy.spatial import cKDTree

    sv = src_sds_p[src_sds_m]
    tv = tgt_sds_p[tgt_sds_m]
    kpt_s = np.zeros((pos_num, 3), np.float32)
    kpt_t = np.zeros((pos_num, 3), np.float32)
    valid = np.zeros(pos_num, bool)
    if len(sv) and len(tv):
        warped = sv @ gt_pose[:3, :3].T + gt_pose[:3, 3]
        d, idx = cKDTree(tv).query(warped)
        mi = np.nonzero(d < voxel_size)[0]
        if len(mi):
            take = rs.choice(len(mi), min(pos_num, len(mi)), replace=False)
            sel = mi[take]
            k = len(sel)
            kpt_s[:k] = sv[sel]
            kpt_t[:k] = tv[idx[sel]]
            valid[:k] = True
    return kpt_s, kpt_t, valid


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy) as tensors on ``device``; ``is_aligned`` stays a
    host bool (the forward branches on it)."""
    out = {k: torch.as_tensor(np.asarray(v)).to(device)
           for k, v in batch.items() if k != "is_aligned"}
    out["is_aligned"] = bool(batch["is_aligned"])
    return out


def stack_batches(batches: list, device) -> dict:
    """A pool: host batches stacked along a new first axis, each key copied
    to ``device`` once. ``is_aligned`` must agree across the pool."""
    flags = {bool(b["is_aligned"]) for b in batches}
    if len(flags) != 1:
        raise ValueError("a pool's batches disagree on is_aligned")
    stacked = {k: np.stack([b[k] for b in batches])
               for k in batches[0] if k != "is_aligned"}
    stacked["is_aligned"] = flags.pop()
    return to_device(stacked, device)


def pool_batch(pool: dict, i: int) -> dict:
    """Batch ``i`` of a pool (views, no copy)."""
    return {k: (v if k == "is_aligned" else v[i]) for k, v in pool.items()}


def build_training_batch(cfg: Config, src_pts: np.ndarray,
                         tgt_pts: np.ndarray, gt_pose: np.ndarray,
                         rs: np.random.RandomState,
                         generator: torch.Generator | None = None,
                         host_arrays: bool = False, device="cuda",
                         noise: torch.Tensor | None = None) -> dict:
    """Raw pair -> fixed-shape training batch dict.

    fds = first downsample at ``cfg.data.downsample`` (plus jitter), sds =
    second downsample at ``cfg.data.voxel_size_0`` (supervision keypoints).
    ``host_arrays=True``: numpy arrays, correspondences on the host.
    Otherwise tensors on ``device``, correspondences sampled there with
    ``noise`` [max_points] (drawn from ``generator`` when not given)."""
    cap = cfg.capacity.max_points
    jitter = cfg.train.augmentation_noise
    src_pts, tgt_pts, gt_pose = rotate_pair(
        src_pts, tgt_pts, gt_pose, rs, cfg.train.rotation_augment)
    src_fds = voxel_downsample_np(src_pts, cfg.data.downsample)
    tgt_fds = voxel_downsample_np(tgt_pts, cfg.data.downsample)
    src_fds = src_fds + rs.randn(*src_fds.shape).astype(np.float32) * jitter
    tgt_fds = tgt_fds + rs.randn(*tgt_fds.shape).astype(np.float32) * jitter
    src_sds = voxel_downsample_np(src_fds, cfg.data.voxel_size_0)
    tgt_sds = voxel_downsample_np(tgt_fds, cfg.data.voxel_size_0)

    src_fds_p, src_fds_m = _pad(src_fds, cap, rs)
    tgt_fds_p, tgt_fds_m = _pad(tgt_fds, cap, rs)
    src_sds_p, src_sds_m = _pad(src_sds, cap, rs)
    tgt_sds_p, tgt_sds_m = _pad(tgt_sds, cap, rs)
    gt_pose = np.asarray(gt_pose, np.float32)
    is_aligned = np.asarray(bool(cfg.patch.is_aligned_to_global_z))
    clouds = {"src_fds": src_fds_p, "src_fds_mask": src_fds_m,
              "tgt_fds": tgt_fds_p, "tgt_fds_mask": tgt_fds_m}
    if host_arrays:
        src_kpt, tgt_kpt, corr_valid = _host_gt_correspondences(
            src_sds_p, src_sds_m, tgt_sds_p, tgt_sds_m, gt_pose,
            cfg.data.voxel_size_0, rs, cfg.train.pos_num)
        return {**clouds, "src_kpt": src_kpt, "tgt_kpt": tgt_kpt,
                "corr_valid": corr_valid, "gt_pose": gt_pose,
                "des_r": np.float32(random_des_r(cfg, rs)),
                "is_aligned": is_aligned}

    dev = resolve_device(device)
    out = to_device({**clouds, "gt_pose": gt_pose, "is_aligned": is_aligned,
                     "src_sds": src_sds_p, "src_sds_mask": src_sds_m,
                     "tgt_sds": tgt_sds_p, "tgt_sds_mask": tgt_sds_m}, dev)
    if noise is None:
        noise = torch.rand(cap, generator=generator, device=generator.device)
    out["src_kpt"], out["tgt_kpt"], out["corr_valid"] = \
        sample_gt_correspondences(
            out.pop("src_sds"), out.pop("src_sds_mask"), out.pop("tgt_sds"),
            out.pop("tgt_sds_mask"), out["gt_pose"], cfg.data.voxel_size_0,
            noise.to(dev), cfg.train.pos_num)
    out["des_r"] = torch.tensor(random_des_r(cfg, rs), dtype=torch.float32,
                                device=dev)
    return out


def synthetic_training_stream(cfg: Config, num_batches: int, seed: int = 0,
                              num_points: int = 6000, overlap: float = 0.8,
                              host_arrays: bool = False,
                              device="cuda") -> Iterator[dict]:
    """Procedural training pairs (no data needed): batch i from
    ``RandomState(seed * 10000 + i)``; on the device path the
    correspondence noise comes from a generator seeded with ``seed`` on
    ``device``."""
    gen = None if host_arrays else torch.Generator(
        resolve_device(device)).manual_seed(seed)
    for i in range(num_batches):
        rs = np.random.RandomState(seed * 10000 + i)
        src, tgt, T = synthetic_pair(rs, num_points=num_points,
                                     overlap=overlap, noise=0.001)
        yield build_training_batch(cfg, src, tgt, T, rs, gen,
                                   host_arrays=host_arrays, device=device)
