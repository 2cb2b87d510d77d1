"""End-to-end zero-shot registration: single pairs and batched serving.

Counterpart of :mod:`bufferx_tpu.pipeline.registration`, run eagerly in
PyTorch. There is one implementation, written for a batch of B pairs (the
JAX package maps its single-pair program over the batch with ``vmap``; here
the pair dimension is written out), and :func:`register_pair` is the batch
of one:

1. :func:`_precompute`: with ``clutter_filter``, the density prefilter
   (:mod:`bufferx_tpu_torch.kernels.density`) refines the 2B clouds' masks,
   and everything after it reads the refined ones; one FPS launch for
   all 2B clouds (kernel K1) gives the radius probes and, as their prefix,
   the keypoints; the centroid-centred f32 distance matrices; density-aware
   radii per pair; and, where the fused query can run
   (:func:`fused_query`), the stratified patch selection of every scale
   asked for, for all clouds, in one launch over the matrices (kernel K2).
   Elsewhere the matrices are kept, and each scale selects its patches with
   the query :func:`~bufferx_tpu_torch.geometry.patches.select_patches`
   picks, as the JAX package does: the single-radius stratified query when
   the strips are too long to pack (``max_points / patch_sample >= 128``),
   the block query, or the flat one (torch ops, no kernel of their own).
2. :func:`_scale_candidates`, once per scale: LRF alignment, the SPT
   features (moment pooling, kernel K3, and derotation in "moments" mode;
   the cell query, kernel K4, and derotation in "sampled" mode) over all
   2 B num_fps patches at once with the radius a per-patch divisor, the
   descriptor net (its backbone the fused conv stack, kernel K5, when
   ``fused_conv``), mutual matching per pair, the matched-equi gather
   (rounded through bf16 when ``mxu_gather``, as the JAX one-hot product
   rounds), the cost-volume head and SO(2) pose candidates.
3. :func:`_pool_and_solve`: cross-scale consensus, the sampling-pool
   policy, RANSAC with a weighted-Kabsch refit or GNC-TLS, and optionally
   IRLS refinement, each with a leading pair dimension. The result's
   ``valid`` reads the clouds' own (unfiltered) masks, as in the JAX
   package.

Nothing between the entry point and the result reads a value back to the
host, so a batch is one uninterrupted stream of launches.
:func:`register_batch` runs one batch through all scales (the JAX
package's ``vmap`` of ``register_pair_jit``), and
:func:`register_pairs_batched` is two-phase serving on top of that: scale 0
for every batch, then all scales for the pairs whose scale-0 solve was not
confident; its only host read is one transfer of the inlier counts per batch.

Every entry point and stage opens a span
(:func:`bufferx_tpu_torch.utils.timers.span`, which records only while
tracing is on and adds no synchronisation; the stages time the stream
too): ``bufferx.prepare``
(:func:`prepare_cloud`); ``bufferx.register``, the one root of
:func:`register_batch`, :func:`register_pair`,
:func:`register_pair_early_exit` and :func:`register_pair_timed`;
``bufferx.serve``, the root of :func:`register_pairs_batched`, with
``bufferx.phase1``, ``bufferx.phase2`` and under it ``bufferx.fetch``, the
host read of a batch; in every pass ``bufferx.precompute`` (with
``bufferx.prefilter``, the clutter prefilter), ``bufferx.candidates`` a
scale (with ``bufferx.describe``, the descriptor net) and
``bufferx.solve`` (with ``bufferx.ransac``, the RANSAC solve, and
``bufferx.refine``, IRLS).

Random draws are explicit (:class:`Draws`): the strip offsets of the fused
stratified query or the per-scale offsets of the other queries, and the
RANSAC rank draws. By default they come from a ``torch.Generator``; a test
can pass the JAX package's draws instead. ``exact_topk`` changes nothing
here (every query of the port is exact, as the JAX package's are on the
CPU); ``vmap_scales`` and ``scale_batch_conv``, the JAX package's
schedulings of the same per-scale chain, run the unrolled chain. Pose
estimators other than RANSAC and GNC raise ``NotImplementedError``. :func:`init_params` gives fresh weights with
flax's initializers, for training.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from bufferx_tpu_torch.config import Config
from bufferx_tpu_torch.core.linalg import take_rows
from bufferx_tpu_torch.device import resolve_device
from bufferx_tpu_torch.geometry.cylindrical import spatial_point_transformer
from bufferx_tpu_torch.geometry.lrf import align_patches
from bufferx_tpu_torch.geometry.patches import (
    offset_bounds,
    patch_query,
    select_patches,
)
from bufferx_tpu_torch.geometry.moments import (
    moments_to_features_mm,
    pool_cell_moments,
)
from bufferx_tpu_torch.kernels.density import density_inlier_mask
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
from bufferx_tpu_torch.solver.gnc import gnc_tls_solve
from bufferx_tpu_torch.solver.irls import post_refinement
from bufferx_tpu_torch.solver.ransac import draw_ranks, ransac_pose
from bufferx_tpu_torch.solver.so2 import so2_pose_candidates
from bufferx_tpu_torch.utils.timers import span, spanned

__all__ = [
    "Cloud",
    "Draws",
    "ScaleDraws",
    "Models",
    "RegistrationResult",
    "PipelineStatics",
    "build_models",
    "fused_query",
    "init_params",
    "make_draws",
    "patch_flags",
    "prepare_cloud",
    "stack_clouds",
    "stack_draws",
    "register_batch",
    "register_pair",
    "register_pair_early_exit",
    "register_pair_timed",
    "register_pairs_batched",
]

# the sampled mode's point stem holds [K, G, voxel_sample, 16] f32 several
# times over: its descriptor net runs over at most this many patches a call
# (one pair, or a batch of 2, is one call; a batch of 8 is 4 calls a scale)
SAMPLED_DESC_CHUNK = 6000


class Cloud(NamedTuple):
    """One padded cloud, or with a leading B a stack of them."""
    xyz: torch.Tensor    # [N, 3] f32, padded
    mask: torch.Tensor   # [N] bool


class RegistrationResult(NamedTuple):
    """One pair's result, or with a leading B a batch's."""
    pose: torch.Tensor            # [4, 4]
    num_inliers: torch.Tensor     # solver inliers
    num_mutual: torch.Tensor      # mutual matches over the scales used
    num_consensus: torch.Tensor   # consensus inlier count
    scales_used: torch.Tensor     # int64
    valid: torch.Tensor           # bool


class Draws(NamedTuple):
    """One pair's random draws where the fused query runs
    (:func:`fused_query`), or with a leading B a batch's."""
    strat_src: torch.Tensor   # [num_fps, patch_sample] int in [0, N/S)
    strat_tgt: torch.Tensor   # [num_fps, patch_sample]
    ransac: torch.Tensor      # [num_hypotheses, 3] int in [0, 2^30)


class ScaleDraws(NamedTuple):
    """One pair's random draws where each scale runs its own patch query,
    or with a leading B a batch's. ``patch`` holds each scale's query
    offsets, indexed by the scale's position in the run's scale subset (the
    JAX package's ``keys[4 + 2 j]``), the cloud (source, target) and then
    the query's own shape
    (:func:`~bufferx_tpu_torch.geometry.patches.offset_bounds`):
    [num_scales, 2, num_fps] for the flat query, [num_scales, 2, 2,
    num_fps] for the block query's two levels, [num_scales, 2, num_fps,
    patch_sample] for the single-radius stratified query."""
    patch: torch.Tensor       # [num_scales, 2, ...]
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
    irls_iters: int
    num_hypotheses: int
    ransac_chunk: int
    enable_early_exit: bool
    early_exit_min_inliers: int
    kiss_resolution: float
    desc_mode: str
    desc_pool: str
    desc_width: float
    clutter_filter: bool
    exact_topk: bool
    strat_ball_query: bool
    radius_subsample: int
    radius_source: str
    spt_pool_subsample: int
    vmap_scales: bool
    fused_conv: bool
    scale_batch_conv: bool
    mxu_gather: bool
    block_ball_query: bool
    bq_block: int
    bq_cand_blocks: int
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
            irls_iters=c.irls_iters,
            num_hypotheses=c.num_ransac_hypotheses,
            ransac_chunk=c.ransac_chunk,
            enable_early_exit=m.enable_early_exit,
            early_exit_min_inliers=m.early_exit_min_inliers,
            kiss_resolution=m.kiss_resolution,
            desc_mode=p.desc_mode,
            desc_pool=p.desc_pool,
            desc_width=p.desc_width,
            clutter_filter=cfg.data.clutter_filter,
            exact_topk=p.exact_topk,
            strat_ball_query=p.strat_ball_query,
            radius_subsample=p.radius_subsample,
            radius_source=p.radius_source,
            spt_pool_subsample=p.spt_pool_subsample,
            vmap_scales=p.vmap_scales,
            fused_conv=p.fused_conv,
            scale_batch_conv=p.scale_batch_conv,
            mxu_gather=p.mxu_gather,
            block_ball_query=p.block_ball_query,
            bq_block=p.bq_block,
            bq_cand_blocks=p.bq_cand_blocks,
        )


def _check_ported(s: PipelineStatics) -> None:
    """Raise on options the port does not implement."""
    missing = []
    if s.pose_estimator not in ("ransac", "gnc"):
        missing.append(f"pose_estimator={s.pose_estimator!r}")
    if s.desc_mode not in ("moments", "sampled") or \
            s.desc_pool not in ("gated", "softmax"):
        missing.append(f"desc_mode={s.desc_mode!r}/desc_pool={s.desc_pool!r}")
    if missing:
        raise NotImplementedError(
            "not ported to bufferx_tpu_torch yet: " + "; ".join(missing)
        )


def fused_query(s: PipelineStatics) -> bool:
    """Whether the fused multi-radius stratified query (kernel K2) selects
    the patches: ``strat_ball_query``, ``max_points % patch_sample == 0``,
    and strips short enough for its packed ``rank << 24 | coord`` words
    (``max_points / patch_sample < 128``), the JAX package's conditions."""
    return (s.strat_ball_query and s.max_points % s.patch_sample == 0
            and s.max_points // s.patch_sample < 1 << (31 - QBITS))


def _scale_query(s: PipelineStatics) -> str:
    """The per-scale query where the fused one does not run ("strat",
    "blocks" or "flat"; the pipeline always has the distance matrices)."""
    return patch_query(s.max_points, s.patch_sample, True, s.block_ball_query,
                       s.bq_block, s.bq_cand_blocks, s.strat_ball_query)


def build_models(statics: PipelineStatics, state_dicts: dict,
                 device="cuda", bn_group=None) -> Models:
    """Descriptor net and cost-volume head with loaded weights (bf16
    convs when ``statics.use_bf16``, as the JAX serving path runs; the
    fused conv stack when ``statics.fused_conv`` and the net qualifies).
    ``bn_group``: the ranks that share training BatchNorm statistics."""
    dev = resolve_device(device)
    dt = torch.bfloat16 if statics.use_bf16 else torch.float32
    desc = MiniSpinNet(statics.rad_n, statics.ele_n, statics.azi_n,
                       mode=statics.desc_mode, pool=statics.desc_pool,
                       width=statics.desc_width, compute_dtype=dt,
                       fused_conv=statics.fused_conv, bn_group=bn_group)
    pose = CostVolume(statics.azi_n, compute_dtype=dt, bn_group=bn_group)
    desc.load_state_dict(state_dicts["desc"], strict=True)
    pose.load_state_dict(state_dicts["pose"], strict=True)
    return Models(desc.to(dev).eval(), pose.to(dev).eval())


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard deviations,
    scaled to variance 1 / fan_in (fan_in: all kernel axes but the output
    channels), drawn by the inverse CDF as ``jax.random.truncated_normal``
    draws it."""
    fan_in = w[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
    w.copy_(torch.clamp(z, -2.0, 2.0).to(w.device) * std)


@torch.no_grad()
def init_params(cfg: Config, generator: torch.Generator) -> dict:
    """Fresh weights for both stages, as flax initializes the JAX package's
    models: lecun-normal conv kernels, zero conv biases, unit BatchNorm
    scales, zero BatchNorm biases, zero running means and unit running
    variances. Returns {"desc": state_dict, "pose": state_dict} (CPU
    tensors) for :class:`MiniSpinNet` and :class:`CostVolume`, drawn from
    ``generator`` module by module in state-dict order."""
    p = cfg.patch
    desc = MiniSpinNet(p.rad_n, p.ele_n, p.azi_n, mode=p.desc_mode,
                       pool=p.desc_pool, width=p.desc_width)
    pose = CostVolume(p.azi_n)
    out = {}
    for name, model in (("desc", desc), ("pose", pose)):
        for key, t in model.state_dict(keep_vars=True).items():
            leaf = key.rsplit(".", 1)[1]
            if leaf == "weight":
                _lecun_normal_(t, generator)
            else:
                t.fill_(1.0 if leaf in ("bn_scale", "bn_var") else 0.0)
        out[name] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return out


@spanned("bufferx.prepare")
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
               device, batch: int | None = None) -> Draws | ScaleDraws:
    """The patch query's offsets for both clouds and RANSAC rank draws: one
    pair's, or with ``batch`` those of a batch (a leading ``batch`` on
    each). The ranks are drawn first; then, where the fused query runs, the
    strip offsets, source then target (a :class:`Draws`), elsewhere every
    scale's query offsets (a :class:`ScaleDraws`)."""
    lead = () if batch is None else (batch,)
    ranks = draw_ranks(statics.num_hypotheses, generator, device,
                       batch=1 if batch is None else batch)
    ranks = ranks[0] if batch is None else ranks

    def randint(high, shape):
        return torch.randint(0, high, lead + shape, generator=generator,
                             device=generator.device,
                             dtype=torch.int32).to(device)

    if fused_query(statics):
        l = statics.max_points // statics.patch_sample
        shape = (statics.num_fps, statics.patch_sample)
        return Draws(randint(l, shape), randint(l, shape), ranks)
    kind = _scale_query(statics)
    bounds = offset_bounds(kind, statics.max_points, statics.patch_sample,
                           statics.bq_block, statics.bq_cand_blocks)
    per = (statics.num_scales, 2, statics.num_fps)
    if kind == "flat":
        patch = randint(bounds[0], per)
    elif kind == "blocks":
        patch = torch.stack([randint(hi, per) for hi in bounds],
                            dim=len(lead) + 2)
    else:
        patch = randint(bounds[0], per + (statics.patch_sample,))
    return ScaleDraws(patch, ranks)


def stack_clouds(clouds: Sequence[Cloud]) -> Cloud:
    """[Cloud, ...] -> Cloud with a leading batch dimension."""
    return Cloud(torch.stack([c.xyz for c in clouds]),
                 torch.stack([c.mask for c in clouds]))


def stack_draws(draws: Sequence[Draws | ScaleDraws]) -> Draws | ScaleDraws:
    """[Draws, ...] (or [ScaleDraws, ...]) of single pairs -> the same type
    with a leading batch dimension."""
    return type(draws[0])(*(torch.stack(xs) for xs in zip(*draws)))


class _Shared(NamedTuple):
    """Scale-independent precomputation of a batch of B pairs. The 2B clouds
    are stacked sources first: cloud b is pair b's source, cloud B + b its
    target. ``patches``/``pvalid`` are every scale's patches where the
    fused query ran (else None); ``d2`` is kept where it did not (the
    scales' queries read it), or when asked for."""
    kpts: torch.Tensor      # [2B, nf, 3]
    kpts_v: torch.Tensor    # [2B, nf]
    d2: torch.Tensor | None         # [2B, num_probe, N]
    radii: torch.Tensor     # [B, num_scales]
    patches: torch.Tensor | None    # [2B, R, nf, S, 3], R = scales asked for
    pvalid: torch.Tensor | None     # [2B, R, nf, S]
    xyz: torch.Tensor       # [2B, N, 3] the clouds
    mask: torch.Tensor      # [2B, N] their masks (refined by the prefilter)


class _Candidates(NamedTuple):
    ss: torch.Tensor     # [B, K, 3] src keypoints
    tt: torch.Tensor     # [B, K, 3] matched tgt keypoints
    Rc: torch.Tensor     # [B, K, 3, 3]
    tc: torch.Tensor     # [B, K, 3]
    valid: torch.Tensor  # [B, K] mutual-match bits
    d2: torch.Tensor     # [B, K] descriptor match distance


def _cat_candidates(cands: list) -> _Candidates:
    return _Candidates(*(torch.cat(xs, dim=1) for xs in zip(*cands)))


def _centroid(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    w = mask.to(torch.float32)[..., None]
    return torch.sum(xyz * w, dim=-2) / torch.clamp_min(torch.sum(w, dim=-2),
                                                        1.0)


@spanned("bufferx.precompute", stream=True,
         pairs=lambda statics, src, *_a, **_k: src.xyz.shape[0])
def _precompute(statics: PipelineStatics, src: Cloud, tgt: Cloud,
                draws: Draws | ScaleDraws, scales: tuple,
                keep_d2: bool = False) -> _Shared:
    """src/tgt: stacked clouds [B, N, 3]; draws with a leading B; ``scales``:
    the radius indices whose patches the fused query selects."""
    b = src.xyz.shape[0]
    xyz = torch.cat([src.xyz, tgt.xyz])                          # [2B, N, 3]
    mask = torch.cat([src.mask, tgt.mask])
    if statics.clutter_filter:
        # FPS, d2, the radius cloud's choice and the patches all see the
        # refined masks
        with span("bufferx.prefilter", pairs=b, stream=True):
            mask = density_inlier_mask(xyz, mask)
    idx, v = fps(xyz, mask, statics.num_probe)
    probe = take_rows(xyz, idx)                                  # [2B, P, 3]

    # distances are translation-invariant: centre on the valid centroid
    # first, which keeps the f32 expansion's cancellation error small
    cen = _centroid(xyz, mask)[:, None, :]
    d2 = masked_sqdist(probe - cen, xyz - cen, v, mask)          # [2B, P, N]

    # density-aware radii per pair from its denser cloud (or its sparser
    # one), read off the contiguous 1/subsample column prefix: the prefix is
    # cut here, so that only a quarter of the chosen matrix is copied
    n_valid = mask.sum(dim=1)
    denser_src = n_valid[:b] > n_valid[b:]
    use_src = ~denser_src if statics.radius_source == "sparser" else denser_src
    pairs = torch.arange(b, device=xyz.device)
    chosen = torch.where(use_src, pairs, pairs + b)              # cloud index
    sub = statics.radius_subsample
    keep = xyz.shape[1] // sub if sub > 1 else xyz.shape[1]
    radii = density_aware_radius_from_d2(
        d2[chosen, :, :keep], mask[chosen, :keep], v[chosen],
        thresholds=statics.thresholds, max_r=statics.radius_max, subsample=1,
    )                                                            # [B, T]
    nf = statics.num_fps
    if not fused_query(statics):
        return _Shared(probe[:, :nf], v[:, :nf], d2, radii, None, None, xyz,
                       mask)
    radii_used = torch.clamp_min(
        torch.stack([radii[:, s] for s in scales], dim=1), 1e-3)  # [B, R]
    patches, pvalid = ball_query_stratified_multi(
        xyz, mask, probe[:, :nf], torch.cat([radii_used, radii_used]),
        torch.cat([draws.strat_src, draws.strat_tgt]), statics.patch_sample,
        d2[:, :nf],
    )
    return _Shared(probe[:, :nf], v[:, :nf], d2 if keep_d2 else None, radii,
                   patches, pvalid, xyz, mask)


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


def _describe(models: Models, statics: PipelineStatics,
              inv: torch.Tensor) -> dict:
    """The descriptor net over all patches; in "sampled" mode over
    sub-batches of patches, which bounds the point stem's memory (every
    patch is embedded on its own, so the split changes no value)."""
    k = inv.shape[0]
    chunk = SAMPLED_DESC_CHUNK if statics.desc_mode == "sampled" else k
    with torch.no_grad():
        if k <= chunk:
            return models.desc(inv)
        parts = [models.desc(inv[i:i + chunk]) for i in range(0, k, chunk)]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def _scale_patches(statics: PipelineStatics, pre: _Shared,
                   draws: Draws | ScaleDraws, des_r: torch.Tensor,
                   scale_pos: int):
    """One scale's patches of all 2B clouds, ([2B, nf, S, 3], [2B, nf, S]):
    the fused query's, or the scale's own query over the kept matrices with
    the draws at ``scale_pos``. ``des_r`` [B] is the scale's radius a pair."""
    if pre.patches is not None:
        return pre.patches[:, scale_pos], pre.pvalid[:, scale_pos]
    off = draws.patch[:, scale_pos]                       # [B, 2, ...]
    return select_patches(
        pre.xyz, pre.mask, pre.kpts, des_r.repeat(2),
        torch.cat([off[:, 0], off[:, 1]]), statics.patch_sample,
        d2=pre.d2[:, :statics.num_fps], use_blocks=statics.block_ball_query,
        block=statics.bq_block, cand_blocks=statics.bq_cand_blocks,
        use_strat=statics.strat_ball_query,
    )


def patch_flags(is_aligned: bool | torch.Tensor,
                num_fps: int) -> bool | torch.Tensor:
    """A batch's gravity flags as :func:`align_patches` takes them for its
    ``2B * num_fps`` patches: a bool as it is; a flag a pair [B] as a flag
    a patch, in the patches' order (the sources' clouds, then the
    targets', ``num_fps`` patches a cloud)."""
    if not isinstance(is_aligned, torch.Tensor):
        return is_aligned
    b2 = 2 * is_aligned.shape[0]
    return torch.cat([is_aligned, is_aligned])[:, None].expand(
        b2, num_fps).reshape(-1)


@spanned("bufferx.candidates", stream=True,
         pairs=lambda models, statics, pre, *_a, **_k: pre.radii.shape[0])
def _scale_candidates(models: Models, statics: PipelineStatics,
                      pre: _Shared, draws: Draws | ScaleDraws, scale: int,
                      scale_pos: int,
                      is_aligned: bool | torch.Tensor) -> _Candidates:
    """One scale of a batch: embed all 2B clouds' patches in ONE pass (a
    per-patch radius divisor), match per pair, predict SO(2), pose
    candidates. ``scale`` indexes the radii, ``scale_pos`` the precomputed
    patch stack and the per-scale draws. ``is_aligned``: one bool for the
    batch, or a [B] bool tensor, a flag a pair."""
    b2, nf = pre.kpts_v.shape
    b = b2 // 2
    is_aligned = patch_flags(is_aligned, nf)
    des_r = torch.clamp_min(pre.radii[:, scale], 1e-3)           # [B]
    patches, pmask = _scale_patches(statics, pre, draws, des_r, scale_pos)
    patches = patches.reshape(b2 * nf, -1, 3)
    pmask = pmask.reshape(b2 * nf, -1)
    kpts = pre.kpts.reshape(b2 * nf, 3)
    aligned, _rand_axis, R2 = align_patches(
        patches - kpts[:, None, :], kpts, is_aligned
    )
    r_patch = des_r.repeat(2)[:, None].expand(b2, nf).reshape(-1, 1, 1)
    inv = _spt_features(aligned / r_patch, pmask, statics)
    if statics.use_bf16:
        inv = inv.to(torch.bfloat16)
    with span("bufferx.describe", pairs=b, stream=True):
        out = _describe(models, statics, inv)
    desc2 = out["desc"].reshape(b2, nf, -1)
    equi2 = out["equi"].reshape((b2, nf) + out["equi"].shape[1:])
    R2 = R2.reshape(b2, nf, 3, 3)
    nn, mutual, nn_d2 = mutual_nearest(
        desc2[:b], desc2[b:], pre.kpts_v[:b], pre.kpts_v[b:]
    )
    src_kpts = pre.kpts[:b]
    tt_kpts = take_rows(pre.kpts[b:], nn)
    e = statics.ele_n
    ss_equi = equi2[:b, :, :, 1 : e - 1]
    tt_equi = take_rows(equi2[b:], nn)[:, :, :, 1 : e - 1]
    if statics.mxu_gather:
        # the JAX one-hot product selects bf16-rounded rows
        tt_equi = tt_equi.to(torch.bfloat16).to(torch.float32)
    with torch.no_grad():
        ind = models.pose(ss_equi.flatten(0, 1), tt_equi.flatten(0, 1))
    R_c, t_c = so2_pose_candidates(
        src_kpts, tt_kpts, R2[:b], take_rows(R2[b:], nn),
        ind.reshape(b, nf), statics.azi_n,
    )
    return _Candidates(src_kpts, tt_kpts, R_c, t_c, mutual, nn_d2)


def _solve(statics: PipelineStatics, cand: _Candidates, pool: torch.Tensor,
           rank_draws: torch.Tensor):
    """(pose [B, 4, 4], num_inliers [B]) by the configured solver."""
    if statics.pose_estimator == "gnc":
        res = gnc_tls_solve(cand.ss, cand.tt, pool,
                            noise_bound=statics.kiss_resolution)
    else:
        with span("bufferx.ransac", pairs=cand.ss.shape[0], stream=True):
            res = ransac_pose(cand.ss, cand.tt, pool, cand.valid, rank_draws,
                              dist_th=statics.dist_th,
                              similar_th=statics.similar_th,
                              chunk=statics.ransac_chunk)
    return res.pose, res.num_inliers


@spanned("bufferx.refine", stream=True,
         pairs=lambda statics, pose, *_a, **_k: pose.shape[0])
def _refine(statics: PipelineStatics, pose: torch.Tensor,
            cand: _Candidates) -> torch.Tensor:
    return post_refinement(pose, cand.ss, cand.tt, cand.valid,
                           statics.dist_th, num_iters=statics.irls_iters)


def _sampling_pool(cand: _Candidates, consensus_mask: torch.Tensor,
                  n_valid: torch.Tensor) -> torch.Tensor:
    """RANSAC's sampling pool [B, K]: the consensus inliers when the vote is
    healthy; else the most confident half of the matches; as a last resort
    everything valid (``n_valid``: the valid matches a pair)."""
    valid, d2 = cand.valid, cand.d2
    sorted_d2 = torch.sort(
        torch.where(valid, d2, torch.full_like(d2, float("inf"))), dim=1
    ).values
    med = torch.gather(
        sorted_d2, 1, torch.clamp(n_valid // 2, 0, d2.shape[1] - 1)[:, None])
    confident = valid & (d2 <= med)
    return torch.where(
        consensus_mask.sum(dim=1, keepdim=True) >= 8, consensus_mask,
        torch.where(confident.sum(dim=1, keepdim=True) >= 8, confident, valid),
    )


@spanned("bufferx.solve", stream=True,
         pairs=lambda statics, cand, *_a, **_k: cand.valid.shape[0])
def _pool_and_solve(statics: PipelineStatics, cand: _Candidates,
                    rank_draws: torch.Tensor, src: Cloud, tgt: Cloud,
                    num_scales_used: int,
                    refine: bool | None = None) -> RegistrationResult:
    """Cross-scale consensus -> sampling pool -> pose solve -> result, for a
    batch. ``refine`` overrides ``statics.pose_refine`` (the timed path runs
    the refinement as its own phase)."""
    valid = cand.valid
    consensus_mask, _best, n_consensus = cross_scale_consensus(
        cand.Rc, cand.tc, cand.ss, cand.tt, valid, azi_n=statics.azi_n,
        inlier_th=statics.inlier_th,
    )
    n_valid = torch.sum(valid, dim=1)
    pool = _sampling_pool(cand, consensus_mask, n_valid)
    pose, num_inliers = _solve(statics, cand, pool, rank_draws)
    if statics.pose_refine if refine is None else refine:
        pose = _refine(statics, pose, cand)
    ok = src.mask.any(dim=1) & tgt.mask.any(dim=1) & (n_valid >= 3)
    eye = torch.eye(4, dtype=pose.dtype, device=pose.device)
    return RegistrationResult(
        pose=torch.where(ok[:, None, None], pose, eye),
        num_inliers=num_inliers,
        num_mutual=n_valid,
        num_consensus=n_consensus,
        scales_used=torch.full_like(n_valid, num_scales_used),
        valid=ok,
    )


def _batch_candidates(models: Models, statics: PipelineStatics, src: Cloud,
                      tgt: Cloud, draws: Draws | ScaleDraws, scales: tuple,
                      is_aligned: bool | torch.Tensor) -> list:
    """Per-scale candidates of a batch (stacked clouds, batched draws).
    ``vmap_scales`` and ``scale_batch_conv`` are the JAX package's
    schedulings of the same per-scale chain; here it runs unrolled."""
    pre = _precompute(statics, src, tgt, draws, scales)
    return [_scale_candidates(models, statics, pre, draws, s, j, is_aligned)
            for j, s in enumerate(scales)]


def _register_batch(models: Models, statics: PipelineStatics, src: Cloud,
                    tgt: Cloud, draws: Draws | ScaleDraws, scales: tuple,
                    is_aligned: bool | torch.Tensor) -> RegistrationResult:
    """A batch of pairs through the given scales. With
    ``statics.enable_early_exit`` and more than one scale this is the masked
    early exit: candidates once per scale, the (cheap) consensus + solve
    twice, on scale 0's candidates and on all, and per pair the scale-0
    result where it is confident."""
    cands = _batch_candidates(models, statics, src, tgt, draws, scales,
                              is_aligned)
    res_all = _pool_and_solve(statics, _cat_candidates(cands), draws.ransac,
                              src, tgt, len(scales))
    if not (statics.enable_early_exit and len(scales) > 1):
        return res_all
    res0 = _pool_and_solve(statics, cands[0], draws.ransac, src, tgt, 1)
    take0 = res0.num_inliers >= statics.early_exit_min_inliers

    def pick(a, b):
        return torch.where(take0.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

    return RegistrationResult(*(pick(a, b) for a, b in zip(res0, res_all)))


class _Setup(NamedTuple):
    dev: torch.device
    statics: PipelineStatics
    models: Models
    is_aligned: bool | torch.Tensor


def _aligned_flags(is_aligned, cfg: Config, pairs: int,
                   dev: torch.device) -> bool | torch.Tensor:
    """``is_aligned`` as the path takes it: None is the configuration's
    bool; a Python bool stays one for every pair; a tensor becomes a [pairs]
    bool tensor on ``dev`` (a 0-d one holds for every pair), even when its
    values are all equal."""
    if is_aligned is None:
        return bool(cfg.patch.is_aligned_to_global_z)
    if not isinstance(is_aligned, torch.Tensor):
        return bool(is_aligned)
    flags = is_aligned.to(dev, torch.bool)
    if flags.ndim == 0:
        return flags.expand(pairs)
    if flags.shape != (pairs,):
        raise ValueError(f"is_aligned has shape {tuple(flags.shape)}, "
                         f"expected [{pairs}]: a flag a pair")
    return flags


def _setup(cfg: Config, clouds: Sequence[Cloud], params, is_aligned,
           device) -> _Setup:
    """What every entry point does first: the device, the statics (checked),
    the clouds' device (checked), the models, the gravity flag (one a pair
    when a tensor; ``clouds`` are the sources, then the targets)."""
    dev = resolve_device(device)
    statics = PipelineStatics.from_config(cfg)
    _check_ported(statics)
    for cloud in clouds:
        if cloud.xyz.device.type != dev.type:
            raise ValueError(f"a cloud lives on {cloud.xyz.device}, not on "
                             f"{dev}")
    models = params if isinstance(params, Models) else build_models(
        statics, params, dev
    )
    return _Setup(dev, statics, models,
                  _aligned_flags(is_aligned, cfg, len(clouds) // 2, dev))


def _default_generator(generator):
    return torch.Generator().manual_seed(0) if generator is None else generator


def _first(res: RegistrationResult) -> RegistrationResult:
    """The single pair of a batch of one."""
    return RegistrationResult(*(x[0] for x in res))


@spanned("bufferx.register",
         pairs=lambda cfg, srcs, *_a, **_k: len(srcs))
def register_batch(cfg: Config, srcs: Sequence[Cloud], tgts: Sequence[Cloud],
                   params, *, draws: Draws | ScaleDraws | None = None,
                   generator: torch.Generator | None = None,
                   is_aligned: bool | torch.Tensor | None = None,
                   device="cuda") -> RegistrationResult:
    """Register a batch of B scan pairs with every scale, in one pass: the
    counterpart of the JAX package's ``jax.vmap(register_pair_jit)``.
    Returns one :class:`RegistrationResult` whose tensors have a leading B.

    ``params``: the ``{"desc", "pose"}`` state dicts of
    :func:`bufferx_tpu_torch.tools.weights.load_snapshot`, or prebuilt
    :class:`Models` (build them once with :func:`build_models` when
    registering many pairs). ``draws`` fixes the random draws (a leading B);
    otherwise they come from ``generator`` (a fresh CPU generator seeded 0
    if None). The clouds must already live on ``device``. ``is_aligned``:
    None (the configuration's ``is_aligned_to_global_z``), one bool for the
    whole batch, or a [B] bool tensor, each pair's flag (both branches of
    the LRF alignment run and each patch takes its pair's). With
    ``cfg.match.enable_early_exit`` a pair's result is its scale-0 solve
    where that has at least ``early_exit_min_inliers`` inliers (masked:
    every scale's candidates are computed either way; for the variants that
    save the time see :func:`register_pair_early_exit` and
    :func:`register_pairs_batched`). Any B >= 1 runs as it is: nothing is
    padded, and a pair's result does not depend on what shares its batch.
    """
    dev, statics, models, is_aligned = _setup(
        cfg, tuple(srcs) + tuple(tgts), params, is_aligned, device)
    if len(srcs) != len(tgts) or not srcs:
        raise ValueError(f"{len(srcs)} sources and {len(tgts)} targets")
    if draws is None:
        draws = make_draws(statics, _default_generator(generator), dev,
                           batch=len(srcs))
    return _register_batch(models, statics, stack_clouds(srcs),
                           stack_clouds(tgts), draws,
                           tuple(range(statics.num_scales)), is_aligned)


@spanned("bufferx.register", pairs=1)
def register_pair(cfg: Config, src: Cloud, tgt: Cloud, params, *,
                  generator: torch.Generator | None = None,
                  draws: Draws | ScaleDraws | None = None,
                  is_aligned: bool | torch.Tensor | None = None,
                  device="cuda") -> RegistrationResult:
    """Register one scan pair with every scale: :func:`register_batch` on
    the batch of one (see there for ``params``, early exit and the
    clouds' device). ``draws`` are one pair's (no leading dimension);
    otherwise they come from ``generator`` (a fresh CPU generator seeded 0
    if None). ``is_aligned``: None, a bool, or a 0-d or [1] bool tensor.
    """
    if draws is None:
        statics = PipelineStatics.from_config(cfg)
        draws = make_draws(statics, _default_generator(generator),
                           resolve_device(device))
    # register_batch's body, inside this call's span alone
    return _first(register_batch.__wrapped__(
        cfg, [src], [tgt], params, draws=stack_draws([draws]),
        is_aligned=is_aligned, device=device))


@spanned("bufferx.register", pairs=1)
def register_pair_early_exit(cfg: Config, src: Cloud, tgt: Cloud, params, *,
                             generator: torch.Generator | None = None,
                             draws: tuple | None = None,
                             is_aligned: bool | torch.Tensor | None = None,
                             device="cuda") -> RegistrationResult:
    """Host-dispatched early exit: scale 0 alone, and all scales only when
    its solve has fewer than ``early_exit_min_inliers`` inliers (one host
    read of that count). ``draws``: a pair ``(scale-0 draws, all-scale
    draws)``, as the JAX package derives two sets from its one key."""
    dev, statics, models, is_aligned = _setup(cfg, (src, tgt), params,
                                              is_aligned, device)
    statics = dataclasses.replace(statics, enable_early_exit=False)
    if draws is None:
        generator = _default_generator(generator)
        draws = (make_draws(statics, generator, dev),
                 make_draws(statics, generator, dev))
    sb, tb = stack_clouds([src]), stack_clouds([tgt])
    res0 = _first(_register_batch(models, statics, sb, tb,
                                  stack_draws([draws[0]]), (0,), is_aligned))
    if int(res0.num_inliers) >= statics.early_exit_min_inliers:
        return res0
    return _first(_register_batch(
        models, statics, sb, tb, stack_draws([draws[1]]),
        tuple(range(statics.num_scales)), is_aligned))


@spanned("bufferx.register", pairs=1)
def register_pair_timed(cfg: Config, src: Cloud, tgt: Cloud, params, *,
                        generator: torch.Generator | None = None,
                        draws: Draws | ScaleDraws | None = None,
                        is_aligned: bool | torch.Tensor | None = None,
                        device="cuda"):
    """Per-phase fenced registration. Returns ``(result, phases)`` with
    ``phases`` in seconds of host wall time, each phase ending in
    ``torch.cuda.synchronize()`` on the card:

    - ``desc_time``: FPS, radii, patch selection, descriptor net, mutual
      matching and the SO(2) head (candidate generation, all scales);
    - ``pose_time``: cross-scale consensus and the pose solver;
    - ``pose_optim_time``: IRLS refinement (0.0 when ``pose_refine`` is off).

    The result equals :func:`register_pair`'s without early exit (early exit
    is a serving feature, not part of the timing protocol). The fences keep
    the host from running ahead, so use the untimed path for throughput.
    """
    dev, statics, models, is_aligned = _setup(cfg, (src, tgt), params,
                                              is_aligned, device)
    if draws is None:
        draws = make_draws(statics, _default_generator(generator), dev)
    draws = stack_draws([draws])
    sb, tb = stack_clouds([src]), stack_clouds([tgt])
    scales = tuple(range(statics.num_scales))

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    t0 = fence()
    cand = _cat_candidates(_batch_candidates(models, statics, sb, tb, draws,
                                             scales, is_aligned))
    t1 = fence()
    res = _pool_and_solve(statics, cand, draws.ransac, sb, tb, len(scales),
                          refine=False)
    t2 = fence()
    if statics.pose_refine:
        eye = torch.eye(4, dtype=res.pose.dtype, device=res.pose.device)
        res = res._replace(pose=torch.where(
            res.valid[:, None, None], _refine(statics, res.pose, cand), eye))
    t3 = fence()
    phases = {"desc_time": t1 - t0, "pose_time": t2 - t1,
              "pose_optim_time": (t3 - t2) if statics.pose_refine else 0.0}
    return _first(res), phases


@spanned("bufferx.fetch", pairs=lambda res: res.num_inliers.shape[0])
def _fetch_inliers(res: RegistrationResult) -> list:
    """The one host read of two-phase serving: a batch's inlier counts."""
    return res.num_inliers.tolist()


@spanned("bufferx.serve", pairs=lambda cfg, srcs, *_a, **_k: len(srcs))
def register_pairs_batched(cfg: Config, srcs: Sequence[Cloud],
                           tgts: Sequence[Cloud], params, *,
                           batch_size: int = 4,
                           generator: torch.Generator | None = None,
                           draws: Sequence[tuple] | None = None,
                           is_aligned: bool | torch.Tensor | None = None,
                           split: bool = False, device="cuda") -> list:
    """Batched serving: registers ``len(srcs)`` pairs in batches of
    ``batch_size`` with two-phase early exit. Returns one
    :class:`RegistrationResult` per pair, its tensors views of the batch's
    results on ``device``.

    Phase 1 launches scale 0 for EVERY batch before anything is read back:
    the launches are asynchronous, so the card runs batch after batch while
    the host is still queueing. Phase 2 reads each batch's inlier counts in
    one transfer and sends the pairs with fewer than
    ``early_exit_min_inliers`` through all scales, as one batch.

    The JAX function pads the last batch and every redo batch to
    ``batch_size`` so that each phase reuses one compiled program. Eager
    PyTorch compiles nothing, so nothing is padded here: the last batch and
    the redo batches are as short as they are, and a pair's result does not
    depend on what shares its batch.

    ``draws``: per batch a pair ``(phase-1 draws, phase-2 draws)``, each a
    :class:`Draws` (or :class:`ScaleDraws`) with the batch's length as its
    leading dimension. As in
    the JAX function, where a redone pair takes the key of its SLOT in the
    redo batch, the r-th redone pair of a batch takes row r of the phase-2
    draws. Without ``draws`` both sets of every batch are made from
    ``generator`` before the first launch (a host-to-device copy waits for
    the queued work). ``split``: the JAX package can dispatch a batch as two
    compiled programs instead of one; there is no program boundary here, and
    both values run the same eager sequence. ``is_aligned``: None, one
    bool for every pair, or a [len(srcs)] bool tensor, each pair's flag,
    which follows its pair into the redo batch.
    """
    del split
    dev, statics, models, is_aligned = _setup(
        cfg, tuple(srcs) + tuple(tgts), params, is_aligned, device)
    statics = dataclasses.replace(statics, enable_early_exit=False)
    n = len(srcs)
    if len(tgts) != n or batch_size < 1:
        raise ValueError(f"{n} sources, {len(tgts)} targets, batch_size "
                         f"{batch_size}")
    batches = [list(range(i, min(i + batch_size, n)))
               for i in range(0, n, batch_size)]
    if draws is None:
        generator = _default_generator(generator)
        draws = [tuple(make_draws(statics, generator, dev, batch=len(idx))
                       for _phase in range(2)) for idx in batches]
    if len(draws) != len(batches):
        raise ValueError(f"{len(batches)} batches need as many pairs of "
                         f"draws, got {len(draws)}")
    all_scales = tuple(range(statics.num_scales))

    def run(idx, batch_draws, scales):
        flags = is_aligned
        if isinstance(flags, torch.Tensor):     # views, no host read
            flags = torch.stack([is_aligned[i] for i in idx])
        return _register_batch(
            models, statics, stack_clouds([srcs[i] for i in idx]),
            stack_clouds([tgts[i] for i in idx]), batch_draws, scales,
            flags)

    # phase 1: scale 0 for every batch, no host read
    with span("bufferx.phase1", pairs=n):
        staged = [run(idx, d[0], (0,)) for idx, d in zip(batches, draws)]

    # phase 2: one read per batch, then the unconfident pairs in one batch
    results: list = [None] * n
    with span("bufferx.phase2", pairs=n):
        for idx, d, res0 in zip(batches, draws, staged):
            inliers = _fetch_inliers(res0)
            redo = [j for j in range(len(idx))
                    if inliers[j] < statics.early_exit_min_inliers]
            res_full = None
            if redo:
                d2 = type(d[1])(*(x[:len(redo)] for x in d[1]))
                res_full = run([idx[j] for j in redo], d2, all_scales)
            for j, i in enumerate(idx):
                if j in redo:
                    slot = redo.index(j)
                    results[i] = RegistrationResult(
                        *(x[slot] for x in res_full))
                else:
                    results[i] = RegistrationResult(*(x[j] for x in res0))
    return results
