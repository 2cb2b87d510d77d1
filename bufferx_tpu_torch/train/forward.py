"""Training forward passes for the two stages (Desc, then Pose).

Counterpart of :mod:`bufferx_tpu.train.forward`:

- :func:`sample_gt_correspondences`: warp the source's supervision points
  by the ground-truth pose, 1-NN against the target's, keep matches within
  the voxel size and take ``pos_num`` of them at random (top-k over noise,
  fixed shapes);
- :func:`embed_training`: patches by the flat ball query, LRF alignment,
  the SPT features (moment pooling, kernel K3, or the cell query, kernel K4)
  and the descriptor net in training mode, with the LRF's in-plane axis and,
  for the Pose stage's target, a per-patch rotation about +z;
- :func:`cal_so2_gt`: the azimuth-bin label of each correspondence;
- :func:`desc_stage_loss` and :func:`pose_stage_loss`.

Random draws are explicit (:class:`TrainDraws`), so that a test can feed the
JAX package's. The models run in training mode: BatchNorm normalizes with
the batch's statistics, and the stage losses return the new running
statistics (``aux["batch_stats"]``, buffer name -> tensor) for the train
step to store.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from bufferx_tpu_torch.config import Config
from bufferx_tpu_torch.core.se3 import rotation_z, transform
from bufferx_tpu_torch.geometry.cylindrical import spatial_point_transformer
from bufferx_tpu_torch.geometry.lrf import align_patches
from bufferx_tpu_torch.geometry.moments import (
    moments_to_features_mm,
    pool_cell_moments,
)
from bufferx_tpu_torch.geometry.patches import select_patches
from bufferx_tpu_torch.kernels.neighbors import nearest_neighbor, sqdist
from bufferx_tpu_torch.models.heads import equi_match_scores
from bufferx_tpu_torch.models.layers import running_stats
from bufferx_tpu_torch.train.losses import (
    contrastive_loss,
    huber_loss,
    so2_cross_entropy,
)

__all__ = [
    "TrainStatics",
    "TrainDraws",
    "make_train_draws",
    "sample_gt_correspondences",
    "training_patches",
    "embed_training",
    "cal_so2_gt",
    "desc_stage_loss",
    "pose_stage_loss",
]


@dataclasses.dataclass(frozen=True)
class TrainStatics:
    pos_num: int
    patch_sample: int
    rad_n: int
    ele_n: int
    azi_n: int
    delta: float
    voxel_sample: int
    sphere_chunk: int
    safe_radius: float
    desc_mode: str = "sampled"

    @classmethod
    def from_config(cls, cfg: Config) -> "TrainStatics":
        return cls(
            pos_num=cfg.train.pos_num,
            patch_sample=cfg.patch.num_points_per_patch,
            rad_n=cfg.patch.rad_n,
            ele_n=cfg.patch.ele_n,
            azi_n=cfg.patch.azi_n,
            delta=cfg.patch.delta,
            voxel_sample=cfg.patch.voxel_sample,
            sphere_chunk=cfg.capacity.sphere_query_chunk,
            safe_radius=cfg.match.dist_th,
            desc_mode=cfg.patch.desc_mode,
        )


class TrainDraws(NamedTuple):
    """One training step's random draws."""
    off_src: torch.Tensor   # [pos_num] ints in [0, N): source patch query
    off_tgt: torch.Tensor   # [pos_num]: target patch query
    angles: torch.Tensor    # [pos_num] f32 radians: Pose target SO(2) aug


def make_train_draws(statics: TrainStatics, num_points: int,
                     generator: torch.Generator, device) -> TrainDraws:
    """Draws for one step from ``generator``, made where the generator
    lives and moved to ``device`` (a CUDA generator for a card run: no
    host-to-device copy inside a step)."""
    k, gdev = statics.pos_num, generator.device

    def offsets():
        return torch.randint(0, num_points, (k,), generator=generator,
                             device=gdev).to(device)

    angles = torch.rand(k, generator=generator, device=gdev) * (2.0 * math.pi)
    return TrainDraws(offsets(), offsets(), angles.to(device))


def sample_gt_correspondences(src_sds, src_mask, tgt_sds, tgt_mask, gt_pose,
                              voxel_size, noise: torch.Tensor, pos_num: int):
    """Fixed-size sample of ground-truth correspondences: (src_kpt [P, 3],
    tgt_kpt [P, 3], valid [P]), P = ``pos_num``. ``noise`` [S] are the
    uniform priorities of the source points (the JAX function's
    ``uniform(key, (S,))``); the ``pos_num`` matches of highest noise are
    taken, ties to the lower index as ``lax.top_k`` breaks them."""
    warped = transform(src_sds, gt_pose)
    nn, d2 = nearest_neighbor(warped, tgt_sds, src_mask, tgt_mask)
    is_match = src_mask & (torch.sqrt(d2) < voxel_size)
    scores = torch.where(is_match, noise, float("-inf"))
    vals, idx = torch.sort(scores, descending=True, stable=True)
    vals, idx = vals[:pos_num], idx[:pos_num]
    valid = vals > float("-inf")
    idx = torch.where(valid, idx, 0)
    return src_sds[idx], tgt_sds[nn[idx]], valid


def training_patches(statics: TrainStatics, cloud_xyz, cloud_mask, kpts,
                     des_r, is_aligned: bool, off: torch.Tensor,
                     angles: torch.Tensor | None = None):
    """The patches of ``kpts`` [K, 3] as the SPT reads them: (normalized
    LRF-aligned points [K, P, 3], mask [K, P], the LRFs ``R`` [K, 3, 3],
    their in-plane axis ``rand_axis`` [K, 3], ``aug_R`` [K, 3, 3]). ``off``
    [K] are the patch query's offsets; ``angles`` [K], when given, rotate
    each aligned patch about +z (the Pose stage's target augmentation), else
    ``aug_R`` is the identity."""
    patches, pmask = select_patches(cloud_xyz, cloud_mask, kpts, des_r, off,
                                    statics.patch_sample)
    aligned, rand_axis, R = align_patches(patches - kpts[:, None, :], kpts,
                                          is_aligned)
    aligned = aligned / des_r
    k = kpts.shape[0]
    if angles is not None:
        aug_R = rotation_z(angles)                             # [K, 3, 3]
        aligned = torch.matmul(aligned, aug_R.transpose(1, 2))
        rand_axis = torch.matmul(aug_R, rand_axis[:, :, None])[:, :, 0]
    else:
        aug_R = torch.eye(3, dtype=aligned.dtype,
                          device=aligned.device).expand(k, 3, 3)
    return aligned, pmask, R, rand_axis, aug_R


def embed_training(desc_model, statics: TrainStatics, cloud_xyz, cloud_mask,
                   kpts, des_r, is_aligned: bool, off: torch.Tensor,
                   angles: torch.Tensor | None = None,
                   bn_stats: dict | None = None) -> dict:
    """Training embedding of the patches around ``kpts`` [K, 3]
    (:func:`training_patches`): dict of ``desc`` [K, 32], ``equi``
    [K, 32, ele, azi], ``R``, ``rand_axis`` and ``aug_R``. The SPT features
    come from moment pooling (kernel K3) or the cell query (kernel K4), which
    read point data only; ``desc_model`` runs as it is (in training mode:
    batch statistics, recorded in ``bn_stats``)."""
    aligned, pmask, R, rand_axis, aug_R = training_patches(
        statics, cloud_xyz, cloud_mask, kpts, des_r, is_aligned, off, angles)
    if statics.desc_mode == "moments":
        raw = pool_cell_moments(aligned, pmask, statics.rad_n, statics.ele_n,
                                statics.azi_n, statics.delta)
        inv = moments_to_features_mm(raw, statics.rad_n, statics.ele_n,
                                     statics.azi_n, statics.delta)
    else:
        inv = spatial_point_transformer(aligned, pmask, statics.rad_n,
                                        statics.ele_n, statics.azi_n,
                                        statics.delta, statics.voxel_sample)
    out = desc_model(inv, bn_stats)
    return {"desc": out["desc"], "equi": out["equi"], "R": R,
            "rand_axis": rand_axis, "aug_R": aug_R}


def cal_so2_gt(s_rand_axis, s_R, t_R, gt_rot, azi_n: int, aug_R=None,
               integer: bool = True) -> torch.Tensor:
    """Azimuth-bin ground truth [K]: the source's in-plane axis taken
    through the GT rotation into the target LRF (and its augmentation),
    its azimuth from the source axis in the source LRF, in bins: rounded
    int64 labels (``integer``), or continuous ones."""
    t_axis = torch.matmul(s_rand_axis, gt_rot.T)
    s_axis = torch.matmul(s_rand_axis[:, None, :], s_R)[:, 0]
    t_axis = torch.matmul(t_axis[:, None, :], t_R)[:, 0]
    if aug_R is not None:
        t_axis = torch.matmul(aug_R, t_axis[:, :, None])[:, :, 0]
    proj_t = torch.cat([t_axis[:, :2], torch.zeros_like(t_axis[:, 2:])],
                       dim=-1)                         # onto the xy plane
    proj_t = proj_t / torch.clamp_min(
        torch.linalg.norm(proj_t, dim=-1, keepdim=True), 1e-12)
    s_n = s_axis / torch.clamp_min(
        torch.linalg.norm(s_axis, dim=-1, keepdim=True), 1e-12)
    cos = torch.clamp(torch.sum(s_n * proj_t, dim=-1), -1.0, 1.0)
    dev = torch.arccos(cos)
    # z component of s_n x proj_t
    cross_z = s_n[:, 0] * proj_t[:, 1] - s_n[:, 1] * proj_t[:, 0]
    dev = torch.where(cross_z < 0.0, 2.0 * math.pi - dev, dev)
    label = dev * azi_n / (2.0 * math.pi)
    if integer:
        lab = torch.round(label)
        return torch.where(lab >= azi_n, 0.0, lab).to(torch.int64)
    return torch.where(label >= azi_n, 0.0, label)


def _stage_is_training(*models) -> None:
    for m in models:
        if not m.training:
            raise ValueError("the stage losses run the nets in training mode "
                             "(batch statistics): call .train() first")


def desc_stage_loss(desc_model, statics: TrainStatics, batch: dict,
                    draws: TrainDraws):
    """Desc-stage loss ``4 contrastive + equivariant cross-entropy`` and aux
    (desc_loss, desc_acc, eqv_loss, eqv_acc, batch_stats). ``batch``: the
    training batch's tensors (src/tgt fds clouds and masks, the sampled
    keypoints and their validity, gt_pose, des_r) and ``is_aligned`` a
    host bool. Both halves run from the same running statistics, and the
    new ones are the mean of the two halves' updates (the reference's one
    module sees both calls)."""
    _stage_is_training(desc_model)
    aligned = bool(batch["is_aligned"])
    halves, stats = [], []
    for side, off in (("src", draws.off_src), ("tgt", draws.off_tgt)):
        bn = {}
        halves.append(embed_training(
            desc_model, statics, batch[f"{side}_fds"],
            batch[f"{side}_fds_mask"], batch[f"{side}_kpt"], batch["des_r"],
            aligned, off, bn_stats=bn))
        stats.append(running_stats(desc_model, bn))
    src, tgt = halves
    valid = batch["corr_valid"]
    dist_kpts = torch.sqrt(sqdist(batch["tgt_kpt"], batch["tgt_kpt"]) + 1e-12)
    dist_kpts_src = torch.sqrt(
        sqdist(batch["src_kpt"], batch["src_kpt"]) + 1e-12)
    d_loss, d_acc = contrastive_loss(
        src["desc"], tgt["desc"], dist_kpts, valid,
        safe_radius=statics.safe_radius, dist_keypts_src=dist_kpts_src)
    logits = equi_match_scores(src["equi"], tgt["equi"], statics.azi_n)
    labels = cal_so2_gt(src["rand_axis"], src["R"], tgt["R"],
                        batch["gt_pose"][:3, :3], statics.azi_n, integer=True)
    e_loss, e_acc = so2_cross_entropy(logits, labels, valid)
    loss = 4.0 * d_loss + e_loss
    new_stats = {k: 0.5 * (stats[0][k] + stats[1][k]) for k in stats[0]}
    aux = {"desc_loss": d_loss, "desc_acc": d_acc, "eqv_loss": e_loss,
           "eqv_acc": e_acc, "batch_stats": new_stats}
    return loss, aux


def pose_stage_loss(pose_model, desc_model, statics: TrainStatics,
                    batch: dict, draws: TrainDraws):
    """Pose-stage loss: Huber on the predicted against the GT SO(2) index,
    and aux (match_loss, batch_stats). The frozen descriptor net runs in
    training mode too (batch statistics, as the JAX stage does) without
    gradients, and its statistics are dropped; only the cost-volume head
    gets gradients and new statistics."""
    _stage_is_training(pose_model, desc_model)
    aligned = bool(batch["is_aligned"])
    with torch.no_grad():
        src = embed_training(desc_model, statics, batch["src_fds"],
                             batch["src_fds_mask"], batch["src_kpt"],
                             batch["des_r"], aligned, draws.off_src)
        tgt = embed_training(desc_model, statics, batch["tgt_fds"],
                             batch["tgt_fds_mask"], batch["tgt_kpt"],
                             batch["des_r"], aligned, draws.off_tgt,
                             angles=draws.angles)
    e = statics.ele_n
    bn = {}
    pred = pose_model(src["equi"][:, :, 1:e - 1], tgt["equi"][:, :, 1:e - 1],
                      bn)
    labels = cal_so2_gt(src["rand_axis"], src["R"], tgt["R"],
                        batch["gt_pose"][:3, :3], statics.azi_n,
                        aug_R=tgt["aug_R"], integer=False)
    loss = huber_loss(pred, labels, batch["corr_valid"])
    return loss, {"match_loss": loss,
                  "batch_stats": running_stats(pose_model, bn)}
