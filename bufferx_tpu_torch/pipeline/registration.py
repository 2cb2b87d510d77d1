"""End-to-end zero-shot pair registration (single pair, all scales).

Counterpart of ``register_pair_jit`` -> ``_register_impl`` in
:mod:`bufferx_tpu.pipeline.registration`, run eagerly in PyTorch:

1. :func:`_precompute`: one FPS per cloud (kernel K1, both clouds in one
   launch) gives the radius probes and, as their prefix, the keypoints; the
   centroid-centred f32 distance matrices; density-aware radii; and every
   scale's stratified patch selection in one pass over each matrix
   (kernel K2).
2. :func:`_scale_candidates`, once per scale (unrolled): LRF alignment, the
   SPT features (moment pooling, kernel K3, and derotation in "moments"
   mode; the cell query, kernel K4, and derotation in "sampled" mode), the
   descriptor net (its backbone the fused conv stack, kernel K5, when
   ``fused_conv``), mutual matching, the matched-equi gather (rounded
   through bf16 when ``mxu_gather``, as the JAX one-hot product rounds),
   the cost-volume head and SO(2) pose candidates.
3. :func:`_pool_and_solve`: cross-scale consensus, the sampling-pool
   policy, RANSAC with a weighted-Kabsch refit.

Random draws are explicit (:class:`Draws`): the strip offsets of the
stratified query and the RANSAC rank draws. By default they come from a
``torch.Generator``; a test can pass the JAX package's draws instead.
Options that the JAX package has but this slice does not port (batched and
early-exit serving, GNC, IRLS refinement, other patch queries, the softmax
pool, scale-vmapped or scale-batched convs) raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from bufferx_tpu_torch.config import Config
from bufferx_tpu_torch.device import resolve_device
from bufferx_tpu_torch.geometry.cylindrical import spatial_point_transformer
from bufferx_tpu_torch.geometry.lrf import align_patches
from bufferx_tpu_torch.geometry.moments import (
    moments_to_features_mm,
    pool_cell_moments,
)
from bufferx_tpu_torch.kernels.fps import fps
from bufferx_tpu_torch.kernels.neighbors import masked_sqdist, mutual_nearest
from bufferx_tpu_torch.kernels.radius import density_aware_radius_from_d2
from bufferx_tpu_torch.kernels.strat_pallas import (
    QBITS,
    ball_query_stratified_multi,
)
from bufferx_tpu_torch.models.heads import CostVolume
from bufferx_tpu_torch.models.spinnet import MiniSpinNet
from bufferx_tpu_torch.solver.consensus import cross_scale_consensus
from bufferx_tpu_torch.solver.ransac import draw_ranks, ransac_pose
from bufferx_tpu_torch.solver.so2 import so2_pose_candidates

__all__ = [
    "Cloud",
    "Draws",
    "Models",
    "RegistrationResult",
    "PipelineStatics",
    "build_models",
    "make_draws",
    "prepare_cloud",
    "register_pair",
]


class Cloud(NamedTuple):
    xyz: torch.Tensor    # [N, 3] f32, padded
    mask: torch.Tensor   # [N] bool


class RegistrationResult(NamedTuple):
    pose: torch.Tensor            # [4, 4]
    num_inliers: torch.Tensor     # solver inliers
    num_mutual: torch.Tensor      # mutual matches over all scales
    num_consensus: torch.Tensor   # consensus inlier count
    scales_used: int
    valid: torch.Tensor           # bool


class Draws(NamedTuple):
    strat_src: torch.Tensor   # [num_fps, patch_sample] int in [0, N/S)
    strat_tgt: torch.Tensor   # [num_fps, patch_sample]
    ransac: torch.Tensor      # [num_hypotheses, 3] int in [0, 2^30)


class Models(NamedTuple):
    desc: MiniSpinNet
    pose: CostVolume


@dataclasses.dataclass(frozen=True)
class PipelineStatics:
    """Static configuration extracted from :class:`Config`: the JAX
    package's fields that the ported path reads or refuses. Build it with
    :meth:`from_config` (there are no defaults to fall back on: the JAX
    statics' defaults are not the shipped configuration, e.g. their
    ``mxu_gather`` is False while ``PatchConfig`` ships True)."""

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
    num_hypotheses: int
    ransac_chunk: int
    enable_early_exit: bool
    desc_mode: str
    desc_pool: str
    desc_width: float
    clutter_filter: bool
    strat_ball_query: bool
    radius_subsample: int
    radius_source: str
    spt_pool_subsample: int
    vmap_scales: bool
    fused_conv: bool
    scale_batch_conv: bool
    mxu_gather: bool
    use_bf16: bool = True   # conv stacks in bf16, as the JAX serving path

    @classmethod
    def from_config(cls, cfg: Config) -> "PipelineStatics":
        p, m, c = cfg.patch, cfg.match, cfg.capacity
        return cls(
            max_points=c.max_points,
            num_fps=p.num_fps,
            num_probe=max(p.num_points_radius_estimate, p.num_fps),
            num_scales=p.num_scales,
            thresholds=tuple(p.search_radius_thresholds),
            radius_max=p.radius_max,
            patch_sample=p.num_points_per_patch,
            rad_n=p.rad_n,
            ele_n=p.ele_n,
            azi_n=p.azi_n,
            delta=p.delta,
            voxel_sample=p.voxel_sample,
            inlier_th=m.inlier_th,
            dist_th=m.dist_th,
            similar_th=m.similar_th,
            pose_estimator=m.pose_estimator,
            pose_refine=cfg.test.pose_refine,
            num_hypotheses=c.num_ransac_hypotheses,
            ransac_chunk=c.ransac_chunk,
            enable_early_exit=m.enable_early_exit,
            desc_mode=p.desc_mode,
            desc_pool=p.desc_pool,
            desc_width=p.desc_width,
            clutter_filter=cfg.data.clutter_filter,
            strat_ball_query=p.strat_ball_query,
            radius_subsample=p.radius_subsample,
            radius_source=p.radius_source,
            spt_pool_subsample=p.spt_pool_subsample,
            vmap_scales=p.vmap_scales,
            fused_conv=p.fused_conv,
            scale_batch_conv=p.scale_batch_conv,
            mxu_gather=p.mxu_gather,
        )


def _check_ported(s: PipelineStatics) -> None:
    """Raise on options this slice of the port does not implement."""
    missing = []
    if s.pose_estimator != "ransac":
        missing.append(f"pose_estimator={s.pose_estimator!r} (GNC)")
    if s.pose_refine:
        missing.append("pose_refine=True (IRLS)")
    if s.enable_early_exit:
        missing.append("enable_early_exit=True")
    if s.clutter_filter:
        missing.append("clutter_filter=True (density prefilter)")
    if s.desc_mode not in ("moments", "sampled") or s.desc_pool != "gated":
        missing.append(f"desc_mode={s.desc_mode!r}/desc_pool={s.desc_pool!r}")
    if s.vmap_scales or s.scale_batch_conv:
        missing.append("vmap_scales/scale_batch_conv")
    l = s.max_points // s.patch_sample
    if (not s.strat_ball_query or s.max_points % s.patch_sample
            or l >= 1 << (31 - QBITS)):
        missing.append("a patch query other than the fused stratified one "
                       "(needs max_points % patch_sample == 0 and "
                       "max_points / patch_sample < 128)")
    if missing:
        raise NotImplementedError(
            "not ported to bufferx_tpu_torch yet: " + "; ".join(missing)
        )


def build_models(statics: PipelineStatics, state_dicts: dict,
                 device="cuda") -> Models:
    """Descriptor net and cost-volume head with loaded weights (bf16
    convs when ``statics.use_bf16``, as the JAX serving path runs; the
    fused conv stack when ``statics.fused_conv`` and the net qualifies)."""
    dev = resolve_device(device)
    dt = torch.bfloat16 if statics.use_bf16 else torch.float32
    desc = MiniSpinNet(statics.rad_n, statics.ele_n, statics.azi_n,
                       mode=statics.desc_mode, pool=statics.desc_pool,
                       width=statics.desc_width, compute_dtype=dt,
                       fused_conv=statics.fused_conv)
    pose = CostVolume(statics.azi_n, compute_dtype=dt)
    desc.load_state_dict(state_dicts["desc"], strict=True)
    pose.load_state_dict(state_dicts["pose"], strict=True)
    return Models(desc.to(dev).eval(), pose.to(dev).eval())


def prepare_cloud(xyz: np.ndarray, cfg: Config, seed: int = 0,
                  device="cuda") -> Cloud:
    """Host-side shuffle (FPS start / random-subset semantics) and pad to
    ``capacity.max_points``; the same numpy stream as the JAX package."""
    dev = resolve_device(device)
    cap = cfg.capacity.max_points
    rs = np.random.RandomState(seed)
    xyz = np.asarray(xyz, np.float32)
    if len(xyz) > cap:
        xyz = xyz[rs.choice(len(xyz), cap, replace=False)]
    else:
        xyz = xyz[rs.permutation(len(xyz))]
    out = np.zeros((cap, 3), np.float32)
    out[: len(xyz)] = xyz
    mask = np.zeros(cap, bool)
    mask[: len(xyz)] = True
    return Cloud(torch.from_numpy(out).to(dev), torch.from_numpy(mask).to(dev))


def make_draws(statics: PipelineStatics, generator: torch.Generator,
               device) -> Draws:
    """Strip offsets for both clouds and RANSAC rank draws."""
    l = statics.max_points // statics.patch_sample
    shape = (statics.num_fps, statics.patch_sample)

    def offsets():
        return torch.randint(0, l, shape, generator=generator,
                             device=generator.device,
                             dtype=torch.int32).to(device)

    return Draws(offsets(), offsets(),
                 draw_ranks(statics.num_hypotheses, generator, device))


class _Shared(NamedTuple):
    src_kpts: torch.Tensor      # [nf, 3]
    tgt_kpts: torch.Tensor
    src_kpts_v: torch.Tensor    # [nf]
    tgt_kpts_v: torch.Tensor
    d2_src: torch.Tensor        # [num_probe, N]
    d2_tgt: torch.Tensor
    radii: torch.Tensor         # [num_scales]
    src_patches: torch.Tensor   # [R, nf, S, 3]
    src_pvalid: torch.Tensor    # [R, nf, S]
    tgt_patches: torch.Tensor
    tgt_pvalid: torch.Tensor


class _Candidates(NamedTuple):
    ss: torch.Tensor     # [K, 3] src keypoints
    tt: torch.Tensor     # [K, 3] matched tgt keypoints
    Rc: torch.Tensor     # [K, 3, 3]
    tc: torch.Tensor     # [K, 3]
    valid: torch.Tensor  # [K] mutual-match bits
    d2: torch.Tensor     # [K] descriptor match distance


def _centroid(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    w = mask.to(torch.float32)[:, None]
    return torch.sum(xyz * w, dim=0) / torch.clamp_min(torch.sum(w), 1.0)


def _precompute(statics: PipelineStatics, src: Cloud, tgt: Cloud,
                draws: Draws) -> _Shared:
    idx, v = fps(torch.stack([src.xyz, tgt.xyz]),
                 torch.stack([src.mask, tgt.mask]), statics.num_probe)
    s_probe, t_probe = src.xyz[idx[0]], tgt.xyz[idx[1]]
    s_v, t_v = v[0], v[1]

    # distances are translation-invariant: centre on the valid centroid
    # first, which keeps the f32 expansion's cancellation error small
    c_src = _centroid(src.xyz, src.mask)
    c_tgt = _centroid(tgt.xyz, tgt.mask)
    d2_src = masked_sqdist(s_probe - c_src, src.xyz - c_src, s_v, src.mask)
    d2_tgt = masked_sqdist(t_probe - c_tgt, tgt.xyz - c_tgt, t_v, tgt.mask)

    # density-aware radii from the denser cloud (or the sparser one)
    denser_src = src.mask.sum() > tgt.mask.sum()
    use_src = ~denser_src if statics.radius_source == "sparser" else denser_src
    radii = density_aware_radius_from_d2(
        torch.where(use_src, d2_src, d2_tgt),
        torch.where(use_src, src.mask, tgt.mask),
        torch.where(use_src, s_v, t_v),
        thresholds=statics.thresholds, max_r=statics.radius_max,
        subsample=statics.radius_subsample,
    )
    nf = statics.num_fps
    radii_used = torch.clamp_min(radii, 1e-3)
    sp, sv = ball_query_stratified_multi(
        src.xyz, src.mask, s_probe[:nf], radii_used, draws.strat_src,
        statics.patch_sample, d2_src[:nf],
    )
    tp, tv = ball_query_stratified_multi(
        tgt.xyz, tgt.mask, t_probe[:nf], radii_used, draws.strat_tgt,
        statics.patch_sample, d2_tgt[:nf],
    )
    return _Shared(s_probe[:nf], t_probe[:nf], s_v[:nf], t_v[:nf],
                   d2_src, d2_tgt, radii, sp, sv, tp, tv)


def _spt_features(normed, pmask, statics: PipelineStatics) -> torch.Tensor:
    """Normalized aligned offsets -> descriptor-net input: moments-major
    features [K, 10, G], or in "sampled" mode the SPT's derotated cell
    samples [K, G, voxel_sample, 3]."""
    if statics.desc_mode == "sampled":
        return spatial_point_transformer(
            normed, pmask, statics.rad_n, statics.ele_n, statics.azi_n,
            statics.delta, statics.voxel_sample)
    sub = statics.spt_pool_subsample
    if sub > 1:
        normed, pmask = normed[:, ::sub], pmask[:, ::sub]
    raw = pool_cell_moments(normed, pmask, statics.rad_n, statics.ele_n,
                            statics.azi_n, statics.delta)
    if sub > 1:
        raw = raw * float(sub)
    return moments_to_features_mm(raw, statics.rad_n, statics.ele_n,
                                  statics.azi_n, statics.delta)


def _scale_candidates(models: Models, statics: PipelineStatics,
                      pre: _Shared, scale: int,
                      is_aligned: bool) -> _Candidates:
    """One scale: embed both clouds in ONE descriptor-net call, match,
    predict SO(2), pose candidates."""
    nf = statics.num_fps
    des_r = torch.clamp_min(pre.radii[scale], 1e-3)
    patches = torch.cat([pre.src_patches[scale], pre.tgt_patches[scale]])
    pmask = torch.cat([pre.src_pvalid[scale], pre.tgt_pvalid[scale]])
    kpts = torch.cat([pre.src_kpts, pre.tgt_kpts])
    aligned, _rand_axis, R2 = align_patches(
        patches - kpts[:, None, :], kpts, is_aligned
    )
    inv = _spt_features(aligned / des_r, pmask, statics)
    if statics.use_bf16:
        inv = inv.to(torch.bfloat16)
    with torch.no_grad():
        out = models.desc(inv)
    desc2, equi2 = out["desc"], out["equi"]
    nn, mutual, nn_d2 = mutual_nearest(
        desc2[:nf], desc2[nf:], pre.src_kpts_v, pre.tgt_kpts_v
    )
    tt_kpts = pre.tgt_kpts[nn]
    e = statics.ele_n
    ss_equi = equi2[:nf, :, 1 : e - 1]
    tt_equi = equi2[nf:][nn][:, :, 1 : e - 1]
    if statics.mxu_gather:
        # the JAX one-hot product selects bf16-rounded rows
        tt_equi = tt_equi.to(torch.bfloat16).to(torch.float32)
    with torch.no_grad():
        ind = models.pose(ss_equi, tt_equi)
    R_c, t_c = so2_pose_candidates(
        pre.src_kpts, tt_kpts, R2[:nf], R2[nf:][nn], ind, statics.azi_n
    )
    return _Candidates(pre.src_kpts, tt_kpts, R_c, t_c, mutual, nn_d2)


def _pool_and_solve(statics: PipelineStatics, cand: _Candidates,
                    rank_draws: torch.Tensor, src: Cloud, tgt: Cloud,
                    num_scales_used: int) -> RegistrationResult:
    ss, tt, Rc, tc, valid, d2 = cand
    consensus_mask, _best, n_consensus = cross_scale_consensus(
        Rc, tc, ss, tt, valid, azi_n=statics.azi_n,
        inlier_th=statics.inlier_th,
    )
    # sampling pool: consensus inliers when the vote is healthy; else the
    # most confident half of the matches; as a last resort everything valid
    n_valid = torch.sum(valid)
    sorted_d2 = torch.sort(
        torch.where(valid, d2, torch.full_like(d2, float("inf")))
    ).values
    med = sorted_d2[torch.clamp(n_valid // 2, 0, d2.shape[0] - 1)]
    confident = valid & (d2 <= med)
    pool = torch.where(
        consensus_mask.sum() >= 8, consensus_mask,
        torch.where(confident.sum() >= 8, confident, valid),
    )
    res = ransac_pose(ss, tt, pool, valid, rank_draws,
                      dist_th=statics.dist_th, similar_th=statics.similar_th,
                      chunk=statics.ransac_chunk)
    num_mutual = n_valid
    ok = src.mask.any() & tgt.mask.any() & (num_mutual >= 3)
    eye = torch.eye(4, dtype=res.pose.dtype, device=res.pose.device)
    return RegistrationResult(
        pose=torch.where(ok, res.pose, eye),
        num_inliers=res.num_inliers,
        num_mutual=num_mutual,
        num_consensus=n_consensus,
        scales_used=num_scales_used,
        valid=ok,
    )


def register_pair(cfg: Config, src: Cloud, tgt: Cloud, params, *,
                  generator: torch.Generator | None = None,
                  draws: Draws | None = None,
                  is_aligned: bool | None = None,
                  device="cuda") -> RegistrationResult:
    """Register one scan pair with every scale.

    ``params``: the ``{"desc", "pose"}`` state dicts of
    :func:`bufferx_tpu_torch.tools.weights.load_snapshot`, or prebuilt
    :class:`Models` (build them once with :func:`build_models` when
    registering many pairs). ``draws`` fixes the random draws; otherwise
    they come from ``generator`` (a fresh CPU generator seeded 0 if None).
    The clouds must already live on ``device``.
    """
    dev = resolve_device(device)
    statics = PipelineStatics.from_config(cfg)
    _check_ported(statics)
    if src.xyz.device.type != dev.type or tgt.xyz.device.type != dev.type:
        raise ValueError(f"clouds live on {src.xyz.device}/{tgt.xyz.device}, "
                         f"not on {dev}")
    models = params if isinstance(params, Models) else build_models(
        statics, params, dev
    )
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = make_draws(statics, generator, dev)
    if is_aligned is None:
        is_aligned = cfg.patch.is_aligned_to_global_z
    pre = _precompute(statics, src, tgt, draws)
    cands = [
        _scale_candidates(models, statics, pre, s, bool(is_aligned))
        for s in range(statics.num_scales)
    ]
    cand = _Candidates(*(torch.cat(xs) for xs in zip(*cands)))
    return _pool_and_solve(statics, cand, draws.ransac, src, tgt,
                           statics.num_scales)
