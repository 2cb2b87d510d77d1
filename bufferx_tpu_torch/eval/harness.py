"""Evaluation loop: the reference's ``test.py`` on the port.

Counterpart of :mod:`bufferx_tpu.eval.harness`. Consumes pair samples (the
data layer's dict contract), registers them one pair at a time or in
batches, and writes the reference's aggregate metrics, timing protocol and
CSV artifacts (:mod:`bufferx_tpu_torch.utils.result_io`).

Random draws come from a ``torch.Generator`` seeded with
``cfg.data.manual_seed`` (pair after pair, or batch after batch), or from a
``draws`` argument (a test feeds the JAX package's draws this way).
"""

from __future__ import annotations

import os
import sys
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from bufferx_tpu_torch.config import Config
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.data.prefetch import (
    prefetch_indexed,
    prefetch_iter,
    prefetch_samples,
)
from bufferx_tpu_torch.device import resolve_device
from bufferx_tpu_torch.pipeline.registration import (
    PipelineStatics,
    build_models,
    make_draws,
    prepare_cloud,
    register_batch,
    register_pair,
    register_pair_timed,
)
from bufferx_tpu_torch.utils.progress import ProgressLine
from bufferx_tpu_torch.utils.result_io import (
    write_per_sample_csv,
    write_summary_csv,
)
from bufferx_tpu_torch.utils.timers import AverageMeter, DeviceTimer, Timer

__all__ = ["evaluate_pairs", "evaluate_pairs_batched", "WARMUP"]

WARMUP = 5  # frames excluded from timing stats (reference test.py:24)


def _meters(names):
    return {n: AverageMeter() for n in names}


def _timed_iter(it, timer: Timer):
    """Iterate, timing each ``next()`` (= host data stall under prefetch)."""
    it = iter(it)
    while True:
        timer.tic()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            timer.toc()
        yield item


def _aligned(cfg: Config, sample: dict) -> bool:
    return bool(sample.get("is_aligned_to_global_z",
                           cfg.patch.is_aligned_to_global_z))


def _models(cfg: Config, params, dev):
    """Build the models once for the whole run (``params`` may be state
    dicts or prebuilt models)."""
    if isinstance(params, dict):
        return build_models(PipelineStatics.from_config(cfg), params, dev)
    return params


def _row(sample: dict, i: int, cfg: Config, success: bool, rte: float,
         rre: float, stats: dict, data_time: float, model_time: float,
         phases: dict, pose: np.ndarray) -> dict:
    """One per-sample row (the 15 CSV columns plus the pose)."""
    return dict(
        src_id=sample.get("src_id", i),
        tgt_id=sample.get("tgt_id", i),
        success=int(success),
        rte=rte,
        rre=rre,
        num_inliers=stats["num_inliers"],
        num_mutual_inliers=stats["num_mutual"],
        num_inlier_ind=stats["num_consensus"],
        scales_used=stats["scales_used"],
        data_time=data_time,
        model_time=model_time,
        desc_time=phases["desc_time"],
        pose_time=phases["pose_time"],
        pose_optim_time=phases["pose_optim_time"],
        dataset=sample.get("dataset_name", cfg.data.dataset),
        pose=pose,
    )


_NO_PHASES = {"desc_time": 0.0, "pose_time": 0.0, "pose_optim_time": 0.0}
_STATS = ("num_inliers", "num_mutual", "num_consensus", "scales_used")


def _start_profile(dev: torch.device):
    """A started ``torch.profiler`` profile of the CPU and, on the card,
    CUDA activity."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, i: int) -> str:
    """Stops the profile and writes its Chrome trace into ``profile_dir``."""
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"pair{i}.trace.json")
    prof.export_chrome_trace(path)
    return path


def evaluate_pairs(
    cfg: Config,
    pairs: Iterable[dict],
    params: Any,
    csv_path: str | None = None,
    summary_csv_path: str | None = None,
    log=None,
    profile_dir: str | None = None,
    progress: bool = False,
    enable_timing: bool = False,
    prefetch_workers: int = 2,
    *,
    draws: Sequence | None = None,
    generator: torch.Generator | None = None,
    device="cuda",
) -> dict:
    """Sequential per-pair evaluation with the reference timing protocol
    (the first ``WARMUP`` pairs are left out of the timing means).

    Each element of ``pairs``: dict with ``src_points`` [N,3], ``tgt_points``
    [M,3] (numpy, already voxel-downsampled by the loader), ``relt_pose``
    [4,4], ``src_id``, ``tgt_id``, ``is_aligned_to_global_z`` (bool) and
    optionally ``dataset_name``. Pair i's clouds are prepared with seeds
    ``2i`` and ``2i + 1``.

    ``enable_timing`` switches to :func:`register_pair_timed`: the
    per-sample CSV's desc/pose/pose-optim columns carry measured seconds at
    the cost of two extra synchronizations a pair. ``prefetch_workers`` > 0
    loads samples and prepares clouds in background threads, so that
    ``data_time`` is the host stall, not the preparation cost. ``draws``:
    one :class:`Draws` a pair; otherwise they come from ``generator``
    (default: a CPU generator seeded ``cfg.data.manual_seed``).

    ``log`` (e.g. ``print``) is called every 10 pairs with the running
    recall, errors and model time. ``profile_dir`` traces exactly the pair
    at index ``WARMUP`` with ``torch.profiler`` (CPU and, on the card, CUDA
    activity) and writes its Chrome trace there. ``progress`` draws a
    one-line progress display with failure call-outs.
    """
    dev = resolve_device(device)
    models = _models(cfg, params, dev)
    statics = PipelineStatics.from_config(cfg)
    if draws is None and generator is None:
        generator = torch.Generator().manual_seed(cfg.data.manual_seed)
    meters = _meters(
        ["rte", "rre", "success", "num_inliers", "num_mutual",
         "num_consensus", "scales_used", "data_time", "model_time",
         "desc_time", "pose_time", "pose_optim_time"]
    )
    rows = []
    rte_succ, rre_succ = AverageMeter(), AverageMeter()
    data_timer = Timer()
    line = (ProgressLine(cfg.data.dataset, stream=sys.stderr) if progress
            else None)

    def prepared_stream():
        src_iter = prefetch_samples(pairs, num_workers=prefetch_workers)
        for i, sample in enumerate(src_iter):
            src = prepare_cloud(sample["src_points"], cfg, seed=2 * i,
                                device=dev)
            tgt = prepare_cloud(sample["tgt_points"], cfg, seed=2 * i + 1,
                                device=dev)
            yield i, sample, src, tgt

    stream: Iterable = prepared_stream()
    if prefetch_workers > 0:
        stream = prefetch_iter(stream, depth=3)

    for i, sample, src, tgt in _timed_iter(stream, data_timer):
        pair_draws = (draws[i] if draws is not None
                      else make_draws(statics, generator, dev))
        kw = dict(draws=pair_draws, is_aligned=_aligned(cfg, sample),
                  device=dev)
        phases = _NO_PHASES
        prof = (_start_profile(dev) if profile_dir is not None
                and i == WARMUP else None)
        with DeviceTimer(dev) as t:
            if enable_timing:
                res, phases = register_pair_timed(cfg, src, tgt, models, **kw)
            else:
                res = register_pair(cfg, src, tgt, models, **kw)
        if prof is not None:
            _stop_profile(prof, profile_dir, i)

        T_gt = torch.as_tensor(np.asarray(sample["relt_pose"], np.float32),
                               device=dev)
        rte = float(se3.compute_rte(res.pose, T_gt))
        rre = float(se3.compute_rre(res.pose, T_gt))
        success = rte < cfg.test.rte_thresh and rre < cfg.test.rre_thresh
        stats = {k: int(getattr(res, k)) for k in _STATS}

        if i >= WARMUP:
            meters["data_time"].update(data_timer.diff)
            meters["model_time"].update(t.diff)
            if enable_timing:
                for k, v in phases.items():
                    meters[k].update(v)
        meters["rte"].update(rte)
        meters["rre"].update(rre)
        meters["success"].update(float(success))
        for k in _STATS:
            meters[k].update(stats[k])
        if success:
            rte_succ.update(rte)
            rre_succ.update(rre)
        rows.append(_row(sample, i, cfg, success, rte, rre, stats,
                         data_timer.diff, t.diff, phases,
                         res.pose.cpu().numpy()))
        if line is not None:
            line.update(i, meters["success"].avg, rte, rre, success,
                        pair_id=f"{sample.get('src_id', i)}")
        if log and (i + 1) % 10 == 0:
            log(f"[{i + 1}] recall {meters['success'].avg * 100:.1f}% "
                f"rte {meters['rte'].avg:.3f} rre {meters['rre'].avg:.2f} "
                f"model {meters['model_time'].avg * 1000:.0f}ms")

    if line is not None:
        line.finish()
    summary = dict(
        dataset=cfg.data.dataset,
        num_pairs=meters["success"].count,
        recall=meters["success"].avg,
        rte_mean=rte_succ.avg,
        rte_std=rte_succ.std,
        rre_mean=rre_succ.avg,
        rre_std=rre_succ.std,
        num_inliers_mean=meters["num_inliers"].avg,
        num_mutual_mean=meters["num_mutual"].avg,
        scales_used_mean=meters["scales_used"].avg,
        data_time_mean=meters["data_time"].avg,
        model_time_mean=meters["model_time"].avg,
        model_time_std=meters["model_time"].std,
    )
    if enable_timing:
        for k in ("desc_time", "pose_time", "pose_optim_time"):
            summary[f"{k}_mean"] = meters[k].avg
            summary[f"{k}_std"] = meters[k].std
    if csv_path:
        write_per_sample_csv(csv_path, rows)
    if summary_csv_path:
        write_summary_csv(summary_csv_path, summary)
    summary["rows"] = rows
    return summary


def evaluate_pairs_batched(
    cfg: Config,
    samples: Sequence[dict],
    params: Any,
    batch_size: int = 8,
    prefetch_workers: int = 2,
    csv_path: str | None = None,
    summary_csv_path: str | None = None,
    *,
    draws: Sequence | None = None,
    generator: torch.Generator | None = None,
    device="cuda",
) -> dict:
    """Throughput-oriented evaluation: batches of ``batch_size`` pairs
    through :func:`register_batch`.

    Emits the same per-sample artifacts as :func:`evaluate_pairs` (the
    15-column CSV rows with per-pair poses and the same summary schema);
    ``model_time`` rows carry the batch's time divided by its size, the
    per-phase columns are zero. Pair ``bB + j`` (batch b, slot j) is
    prepared with seeds ``2(bB + j)`` and ``2(bB + j) + 1``. The last batch
    is as short as it is (nothing is padded), and every batch is timed: the
    first batch runs once untimed, as a warm-up whose result is dropped,
    before the timed run. The summary adds ``pairs_per_second`` over all
    pairs. A batch takes one ``is_aligned_to_global_z``: a batch whose
    samples differ in it raises ``ValueError``. ``draws``: one
    :class:`Draws` with the batch's size as its leading dimension a batch;
    otherwise they come from ``generator`` (default: a CPU generator seeded
    ``cfg.data.manual_seed``).
    """
    dev = resolve_device(device)
    models = _models(cfg, params, dev)
    statics = PipelineStatics.from_config(cfg)
    if draws is None and generator is None:
        generator = torch.Generator().manual_seed(cfg.data.manual_seed)
    n = len(samples)
    n_batches = (n + batch_size - 1) // batch_size
    rows = []
    meters = _meters(
        ["num_inliers", "num_mutual", "num_consensus", "scales_used",
         "data_time", "model_time"]
    )
    data_timer = Timer()

    def build_batch(b):
        idx = range(b * batch_size, min((b + 1) * batch_size, n))
        chunk = [samples[i] for i in idx]
        aligned = {_aligned(cfg, s) for s in chunk}
        if len(aligned) > 1:
            raise ValueError(
                f"batch {b} mixes is_aligned_to_global_z values; a batch "
                "takes one")
        srcs = [prepare_cloud(samples[i]["src_points"], cfg, seed=2 * i,
                              device=dev) for i in idx]
        tgts = [prepare_cloud(samples[i]["tgt_points"], cfg, seed=2 * i + 1,
                              device=dev) for i in idx]
        return chunk, srcs, tgts, aligned.pop()

    if prefetch_workers > 0:
        batch_stream = prefetch_indexed(
            build_batch, n_batches, num_workers=prefetch_workers, depth=2
        )
    else:
        batch_stream = (build_batch(b) for b in range(n_batches))

    throughput_time = 0.0
    for b, (chunk, srcs, tgts, aligned) in enumerate(
        _timed_iter(batch_stream, data_timer)
    ):
        real = len(chunk)
        batch_draws = (draws[b] if draws is not None
                       else make_draws(statics, generator, dev, batch=real))
        kw = dict(draws=batch_draws, is_aligned=aligned, device=dev)
        if b == 0:
            register_batch(cfg, srcs, tgts, models, **kw)      # warm-up
        with DeviceTimer(dev) as t:
            res = register_batch(cfg, srcs, tgts, models, **kw)
        throughput_time += t.diff

        gts = torch.as_tensor(
            np.stack([np.asarray(s["relt_pose"], np.float32) for s in chunk]),
            device=dev)
        rte_b = se3.compute_rte(res.pose, gts).cpu().numpy()
        rre_b = se3.compute_rre(res.pose, gts).cpu().numpy()
        poses = res.pose.cpu().numpy()
        stats_b = {k: getattr(res, k).cpu().numpy() for k in _STATS}
        for j, s in enumerate(chunk):
            i = b * batch_size + j
            success_j = bool(rte_b[j] < cfg.test.rte_thresh
                             and rre_b[j] < cfg.test.rre_thresh)
            stats = {k: int(v[j]) for k, v in stats_b.items()}
            meters["data_time"].update(data_timer.diff / real)
            meters["model_time"].update(t.diff / real)
            for k in _STATS:
                meters[k].update(stats[k])
            rows.append(_row(s, i, cfg, success_j, float(rte_b[j]),
                             float(rre_b[j]), stats, data_timer.diff / real,
                             t.diff / real, _NO_PHASES, poses[j]))

    all_rte = np.asarray([r["rte"] for r in rows])
    all_rre = np.asarray([r["rre"] for r in rows])
    success = (all_rte < cfg.test.rte_thresh) & (all_rre < cfg.test.rre_thresh)
    rte_s = all_rte[success]
    rre_s = all_rre[success]
    summary = dict(
        dataset=cfg.data.dataset,
        num_pairs=int(len(rows)),
        recall=float(success.mean()) if len(rows) else float("nan"),
        rte_mean=float(rte_s.mean()) if success.any() else float("nan"),
        rte_std=float(rte_s.std()) if success.any() else float("nan"),
        rre_mean=float(rre_s.mean()) if success.any() else float("nan"),
        rre_std=float(rre_s.std()) if success.any() else float("nan"),
        num_inliers_mean=meters["num_inliers"].avg,
        num_mutual_mean=meters["num_mutual"].avg,
        scales_used_mean=meters["scales_used"].avg,
        data_time_mean=meters["data_time"].avg,
        model_time_mean=meters["model_time"].avg,
        model_time_std=meters["model_time"].std,
        pairs_per_second=(len(rows) / throughput_time
                          if throughput_time > 0 else float("nan")),
    )
    if csv_path:
        write_per_sample_csv(csv_path, rows)
    if summary_csv_path:
        write_summary_csv(summary_csv_path, summary)
    summary["rows"] = rows
    return summary
