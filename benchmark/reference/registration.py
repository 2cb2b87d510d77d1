"""Plain reference of zero-shot registration: batched two-phase serving.

A frozen copy of the port's batched pipeline (``pipeline/registration.py``
of the program) on the plain versions of its kernels (FPS, the fused
stratified query, SPT moments, the cell query, the conv stack), in the
configuration's precision: float32 with TF32 off, bf16 convolutions. It
imports nothing of the program; the configuration's statics come from the
benchmark's configuration file and the weights from the snapshot files.

Only what the benchmark's configurations run is here: the fused
stratified query (``max_points % patch_sample == 0`` and short strips),
the RANSAC solver, optional IRLS refinement and the density prefilter.

:func:`register_batch` is one batch through the given scales;
:func:`register_batches` is two-phase serving over a list of batches (scale
0 for every batch, then all scales for the pairs whose scale-0 solve has
fewer than ``early_exit_min_inliers`` inliers, the r-th redone pair of a
batch on row r of the batch's phase-2 draws).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from benchmark.reference.core.linalg import take_rows
from benchmark.reference.geometry.cylindrical import spatial_point_transformer
from benchmark.reference.geometry.lrf import align_patches
from benchmark.reference.geometry.moments import (
    moments_to_features_mm,
    pool_cell_moments,
)
from benchmark.reference.kernels.density import density_inlier_mask
from benchmark.reference.kernels.fps import fps
from benchmark.reference.kernels.neighbors import masked_sqdist, mutual_nearest
from benchmark.reference.kernels.radius import density_aware_radius_from_d2
from benchmark.reference.kernels.strat_pallas import (
    QBITS,
    ball_query_stratified_multi,
)
from benchmark.reference.models.heads import CostVolume
from benchmark.reference.models.spinnet import MiniSpinNet
from benchmark.reference.solver.consensus import cross_scale_consensus
from benchmark.reference.solver.irls import post_refinement
from benchmark.reference.solver.ransac import ransac_pose
from benchmark.reference.solver.so2 import so2_pose_candidates

__all__ = ["Statics", "Cloud", "Draws", "Result", "Models", "build_models",
           "prepare_cloud", "register_batch", "register_batches"]

# the sampled mode's point stem holds [K, G, voxel_sample, 16] f32 several
# times over: its descriptor net runs over at most this many patches a call
SAMPLED_DESC_CHUNK = 6000


@dataclasses.dataclass(frozen=True)
class Statics:
    """The configuration as the pipeline reads it (the ``statics`` object
    of a configuration file)."""
    max_points: int
    num_fps: int
    num_probe: int
    num_scales: int
    thresholds: tuple
    radius_max: float
    patch_sample: int
    rad_n: int
    ele_n: int
    azi_n: int
    delta: float
    voxel_sample: int
    inlier_th: float
    dist_th: float
    similar_th: float
    pose_estimator: str
    pose_refine: bool
    irls_iters: int
    num_hypotheses: int
    ransac_chunk: int
    early_exit_min_inliers: int
    desc_mode: str
    desc_pool: str
    desc_width: float
    clutter_filter: bool
    radius_subsample: int
    radius_source: str
    spt_pool_subsample: int
    fused_conv: bool
    mxu_gather: bool
    is_aligned: bool
    use_bf16: bool

    @classmethod
    def from_dict(cls, d: dict) -> "Statics":
        fields = {f.name for f in dataclasses.fields(cls)}
        missing = fields - set(d)
        if missing:
            raise ValueError(f"statics lack {sorted(missing)}")
        kw = {k: d[k] for k in fields}
        kw["thresholds"] = tuple(kw["thresholds"])
        s = cls(**kw)
        if s.pose_estimator != "ransac":
            raise NotImplementedError("the reference runs the RANSAC solver")
        l = s.max_points // s.patch_sample
        if s.max_points % s.patch_sample or l >= 1 << (31 - QBITS):
            raise NotImplementedError("the reference runs the fused "
                                      "stratified query only")
        return s


class Cloud(NamedTuple):
    xyz: torch.Tensor    # [N, 3] f32 padded, or [B, N, 3]
    mask: torch.Tensor   # [N] bool, or [B, N]


class Draws(NamedTuple):
    strat_src: torch.Tensor   # [B, num_fps, patch_sample] int in [0, N/S)
    strat_tgt: torch.Tensor
    ransac: torch.Tensor      # [B, num_hypotheses, 3] int in [0, 2^30)


class Result(NamedTuple):
    pose: torch.Tensor            # [B, 4, 4]
    num_inliers: torch.Tensor
    num_mutual: torch.Tensor
    num_consensus: torch.Tensor
    scales_used: torch.Tensor
    valid: torch.Tensor


class Models(NamedTuple):
    desc: MiniSpinNet
    pose: CostVolume


class _Shared(NamedTuple):
    kpts: torch.Tensor      # [2B, nf, 3]
    kpts_v: torch.Tensor    # [2B, nf]
    radii: torch.Tensor     # [B, num_scales]
    patches: torch.Tensor   # [2B, R, nf, S, 3]
    pvalid: torch.Tensor    # [2B, R, nf, S]


class _Candidates(NamedTuple):
    ss: torch.Tensor
    tt: torch.Tensor
    Rc: torch.Tensor
    tc: torch.Tensor
    valid: torch.Tensor
    d2: torch.Tensor


def build_models(s: Statics, state_dicts: dict, device) -> Models:
    dt = torch.bfloat16 if s.use_bf16 else torch.float32
    desc = MiniSpinNet(s.rad_n, s.ele_n, s.azi_n, mode=s.desc_mode,
                       pool=s.desc_pool, width=s.desc_width, compute_dtype=dt,
                       fused_conv=s.fused_conv)
    pose = CostVolume(s.azi_n, compute_dtype=dt)
    desc.load_state_dict(state_dicts["desc"], strict=True)
    pose.load_state_dict(state_dicts["pose"], strict=True)
    return Models(desc.to(device).eval(), pose.to(device).eval())


def prepare_cloud(xyz: np.ndarray, max_points: int, seed: int,
                  device) -> Cloud:
    """Host-side shuffle and pad to ``max_points`` (a random subset when
    the cloud is larger), from ``np.random.RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    xyz = np.asarray(xyz, np.float32)
    if len(xyz) > max_points:
        xyz = xyz[rs.choice(len(xyz), max_points, replace=False)]
    else:
        xyz = xyz[rs.permutation(len(xyz))]
    out = np.zeros((max_points, 3), np.float32)
    out[: len(xyz)] = xyz
    mask = np.zeros(max_points, bool)
    mask[: len(xyz)] = True
    return Cloud(torch.from_numpy(out).to(device),
                 torch.from_numpy(mask).to(device))


def _centroid(xyz, mask):
    w = mask.to(torch.float32)[..., None]
    return torch.sum(xyz * w, dim=-2) / torch.clamp_min(torch.sum(w, dim=-2),
                                                        1.0)


def _precompute(s: Statics, src: Cloud, tgt: Cloud, draws: Draws,
                scales: tuple) -> _Shared:
    b = src.xyz.shape[0]
    xyz = torch.cat([src.xyz, tgt.xyz])
    mask = torch.cat([src.mask, tgt.mask])
    if s.clutter_filter:
        mask = density_inlier_mask(xyz, mask)
    idx, v = fps(xyz, mask, s.num_probe)
    probe = take_rows(xyz, idx)
    cen = _centroid(xyz, mask)[:, None, :]
    d2 = masked_sqdist(probe - cen, xyz - cen, v, mask)
    n_valid = mask.sum(dim=1)
    denser_src = n_valid[:b] > n_valid[b:]
    use_src = ~denser_src if s.radius_source == "sparser" else denser_src
    pairs = torch.arange(b, device=xyz.device)
    chosen = torch.where(use_src, pairs, pairs + b)
    sub = s.radius_subsample
    keep = xyz.shape[1] // sub if sub > 1 else xyz.shape[1]
    radii = density_aware_radius_from_d2(
        d2[chosen, :, :keep], mask[chosen, :keep], v[chosen],
        thresholds=s.thresholds, max_r=s.radius_max, subsample=1)
    nf = s.num_fps
    radii_used = torch.clamp_min(
        torch.stack([radii[:, j] for j in scales], dim=1), 1e-3)
    patches, pvalid = ball_query_stratified_multi(
        xyz, mask, probe[:, :nf], torch.cat([radii_used, radii_used]),
        torch.cat([draws.strat_src, draws.strat_tgt]), s.patch_sample,
        d2[:, :nf])
    return _Shared(probe[:, :nf], v[:, :nf], radii, patches, pvalid)


def _spt_features(normed, pmask, s: Statics) -> torch.Tensor:
    if s.desc_mode == "sampled":
        return spatial_point_transformer(normed, pmask, s.rad_n, s.ele_n,
                                         s.azi_n, s.delta, s.voxel_sample)
    sub = s.spt_pool_subsample
    if sub > 1:
        normed, pmask = normed[:, ::sub], pmask[:, ::sub]
    raw = pool_cell_moments(normed, pmask, s.rad_n, s.ele_n, s.azi_n,
                            s.delta)
    if sub > 1:
        raw = raw * float(sub)
    return moments_to_features_mm(raw, s.rad_n, s.ele_n, s.azi_n, s.delta)


def _describe(models: Models, s: Statics, inv: torch.Tensor) -> dict:
    k = inv.shape[0]
    chunk = SAMPLED_DESC_CHUNK if s.desc_mode == "sampled" else k
    if k <= chunk:
        return models.desc(inv)
    parts = [models.desc(inv[i:i + chunk]) for i in range(0, k, chunk)]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def _scale_candidates(models: Models, s: Statics, pre: _Shared, scale: int,
                      scale_pos: int) -> _Candidates:
    b2, nf = pre.kpts_v.shape
    b = b2 // 2
    des_r = torch.clamp_min(pre.radii[:, scale], 1e-3)
    patches = pre.patches[:, scale_pos].reshape(b2 * nf, -1, 3)
    pmask = pre.pvalid[:, scale_pos].reshape(b2 * nf, -1)
    kpts = pre.kpts.reshape(b2 * nf, 3)
    aligned, _axis, R2 = align_patches(patches - kpts[:, None, :], kpts,
                                       s.is_aligned)
    r_patch = des_r.repeat(2)[:, None].expand(b2, nf).reshape(-1, 1, 1)
    inv = _spt_features(aligned / r_patch, pmask, s)
    if s.use_bf16:
        inv = inv.to(torch.bfloat16)
    out = _describe(models, s, inv)
    desc2 = out["desc"].reshape(b2, nf, -1)
    equi2 = out["equi"].reshape((b2, nf) + out["equi"].shape[1:])
    R2 = R2.reshape(b2, nf, 3, 3)
    nn, mutual, nn_d2 = mutual_nearest(desc2[:b], desc2[b:], pre.kpts_v[:b],
                                       pre.kpts_v[b:])
    src_kpts = pre.kpts[:b]
    tt_kpts = take_rows(pre.kpts[b:], nn)
    e = s.ele_n
    ss_equi = equi2[:b, :, :, 1:e - 1]
    tt_equi = take_rows(equi2[b:], nn)[:, :, :, 1:e - 1]
    if s.mxu_gather:
        tt_equi = tt_equi.to(torch.bfloat16).to(torch.float32)
    ind = models.pose(ss_equi.flatten(0, 1), tt_equi.flatten(0, 1))
    R_c, t_c = so2_pose_candidates(src_kpts, tt_kpts, R2[:b],
                                   take_rows(R2[b:], nn), ind.reshape(b, nf),
                                   s.azi_n)
    return _Candidates(src_kpts, tt_kpts, R_c, t_c, mutual, nn_d2)


def _pool_and_solve(s: Statics, cand: _Candidates, rank_draws, src: Cloud,
                    tgt: Cloud, num_scales_used: int) -> Result:
    valid, d2 = cand.valid, cand.d2
    consensus_mask, _best, n_consensus = cross_scale_consensus(
        cand.Rc, cand.tc, cand.ss, cand.tt, valid, azi_n=s.azi_n,
        inlier_th=s.inlier_th)
    n_valid = torch.sum(valid, dim=1)
    sorted_d2 = torch.sort(
        torch.where(valid, d2, torch.full_like(d2, float("inf"))), dim=1
    ).values
    med = torch.gather(
        sorted_d2, 1, torch.clamp(n_valid // 2, 0, d2.shape[1] - 1)[:, None])
    confident = valid & (d2 <= med)
    pool = torch.where(
        consensus_mask.sum(dim=1, keepdim=True) >= 8, consensus_mask,
        torch.where(confident.sum(dim=1, keepdim=True) >= 8, confident, valid))
    res = ransac_pose(cand.ss, cand.tt, pool, cand.valid, rank_draws,
                      dist_th=s.dist_th, similar_th=s.similar_th,
                      chunk=s.ransac_chunk)
    pose = res.pose
    if s.pose_refine:
        pose = post_refinement(pose, cand.ss, cand.tt, cand.valid, s.dist_th,
                               num_iters=s.irls_iters)
    ok = src.mask.any(dim=1) & tgt.mask.any(dim=1) & (n_valid >= 3)
    eye = torch.eye(4, dtype=pose.dtype, device=pose.device)
    return Result(pose=torch.where(ok[:, None, None], pose, eye),
                  num_inliers=res.num_inliers, num_mutual=n_valid,
                  num_consensus=n_consensus,
                  scales_used=torch.full_like(n_valid, num_scales_used),
                  valid=ok)


@torch.no_grad()
def register_batch(models: Models, s: Statics, src: Cloud, tgt: Cloud,
                   draws: Draws, scales: tuple) -> Result:
    """A batch of pairs (stacked clouds, batched draws) through ``scales``,
    solved on the candidates of all of them."""
    pre = _precompute(s, src, tgt, draws, scales)
    cands = [_scale_candidates(models, s, pre, j, pos)
             for pos, j in enumerate(scales)]
    cand = _Candidates(*(torch.cat(xs, dim=1) for xs in zip(*cands)))
    return _pool_and_solve(s, cand, draws.ransac, src, tgt, len(scales))


def _stack(clouds: Sequence[Cloud]) -> Cloud:
    return Cloud(torch.stack([c.xyz for c in clouds]),
                 torch.stack([c.mask for c in clouds]))


def _rows(draws: Draws, n: int) -> Draws:
    return Draws(*(x[:n] for x in draws))


def register_batches(models: Models, s: Statics, srcs: Sequence[Cloud],
                     tgts: Sequence[Cloud], batches: Sequence[Sequence[int]],
                     draws: Sequence[tuple]) -> list:
    """Two-phase serving: ``batches`` lists the pair indices of each batch,
    ``draws`` a (phase-1, phase-2) pair of :class:`Draws` a batch. Returns
    one :class:`Result` of single-pair tensors a pair, in pair order."""
    results: dict = {}
    all_scales = tuple(range(s.num_scales))
    for idx, (d1, d2) in zip(batches, draws):
        src = _stack([srcs[i] for i in idx])
        tgt = _stack([tgts[i] for i in idx])
        res0 = register_batch(models, s, src, tgt, d1, (0,))
        inliers = res0.num_inliers.tolist()
        redo = [j for j in range(len(idx))
                if inliers[j] < s.early_exit_min_inliers]
        res_all = None
        if redo:
            res_all = register_batch(
                models, s, _stack([srcs[idx[j]] for j in redo]),
                _stack([tgts[idx[j]] for j in redo]), _rows(d2, len(redo)),
                all_scales)
        for j, i in enumerate(idx):
            if j in redo:
                results[i] = Result(*(x[redo.index(j)] for x in res_all))
            else:
                results[i] = Result(*(x[j] for x in res0))
    return [results[i] for i in sorted(results)]
