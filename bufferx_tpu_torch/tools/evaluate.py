"""Benchmark evaluation CLI: the port of ``scripts/evaluate.py``.

    python3 -m bufferx_tpu_torch.tools.evaluate --dataset 3DMatch \\
        --root ../datasets/ThreeDMatch --checkpoint-dir snapshot/hard_moments_r4ft2
    python3 -m bufferx_tpu_torch.tools.evaluate --dataset KITTI \\
        --root ../datasets/kitti --pose-estimator gnc --enable-early-exit
    python3 -m bufferx_tpu_torch.tools.evaluate --dataset TIERS_hetero \\
        --root ../datasets/tiers --hetero os0_128:os1_64
    python3 -m bufferx_tpu_torch.tools.evaluate --dataset Synthetic \\
        --num-pairs 8 --cpu --fast                  # no data, on the CPU

The same flags as the JAX script: the ablation flags
(``--num-points-per-patch``, ``--num-scales``, ``--num-fps``,
``--search-radius-thresholds``, ``--desc-mode``, ``--pose-refine``), the
solver and early exit, ``--fast`` (reduced capacities), ``--batched B``
(the batched evaluation), ``--enable-timing``, ``--profile-dir`` (a
``torch.profiler`` trace of one steady-state pair), ``--progress``,
``--max-pairs``, ``--seed`` and ``--out-dir``. A ``--checkpoint-dir``'s
``config.json`` takes precedence over the flags. The outputs are the JAX
script's: the per-sample CSV, ``summary.csv``, the ``full_results`` CSV
and the summary table; for 3DMatch and 3DLoMatch also one trajectory
``.log`` per scene, re-scored with the RMSE / ``gt.info`` protocol
(:func:`rmse_protocol`) where the ground truth files are there. It runs on
the card; ``--cpu`` runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch

__all__ = ["parse_args", "apply_overrides", "synthetic_pairs",
           "rmse_protocol", "run", "main"]


def parse_args(argv=None):
    from bufferx_tpu_torch.config import DATASETS

    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--dataset", required=True,
                    choices=sorted(DATASETS) + ["Synthetic"])
    ap.add_argument("--root", default="", help="dataset root directory")
    ap.add_argument("--experiment-id", default="bufferx_tpu")
    ap.add_argument("--checkpoint-dir", default="",
                    help="snapshot dir with Desc/best.msgpack + "
                         "Pose/best.msgpack")
    ap.add_argument("--pose-estimator", choices=["ransac", "gnc"],
                    default=None)
    ap.add_argument("--pose-refine", action="store_true", default=None)
    ap.add_argument("--enable-early-exit", action="store_true", default=None)
    ap.add_argument("--num-points-per-patch", type=int, default=None)
    ap.add_argument("--num-scales", type=int, default=None)
    ap.add_argument("--num-fps", type=int, default=None)
    ap.add_argument("--search-radius-thresholds", type=float, nargs="+",
                    default=None)
    ap.add_argument("--desc-mode", choices=["sampled", "moments"],
                    default=None,
                    help="cell pooling mode (must match the checkpoint)")
    ap.add_argument("--hetero", default=None,
                    help="src_sensor:tgt_sensor for *_hetero datasets")
    ap.add_argument("--max-pairs", type=int, default=None)
    ap.add_argument("--num-pairs", type=int, default=16,
                    help="Synthetic dataset size")
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--fast", action="store_true",
                    help="shrunken capacities for smoke runs (esp. --cpu)")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--batched", type=int, default=0, metavar="B",
                    help="evaluate batches of B pairs (same per-sample CSV "
                         "and RMSE outputs as the sequential path)")
    ap.add_argument("--enable-timing", action="store_true",
                    help="per-phase desc/pose/pose-optim timing in the CSV")
    ap.add_argument("--profile-dir", default=None,
                    help="write a trace of one steady-state pair")
    ap.add_argument("--progress", action="store_true",
                    help="single-line progress UI with failure call-outs")
    return ap.parse_args(argv)


def apply_overrides(cfg, args):
    """The flags' configuration changes, as the JAX script applies them."""
    patch = {}
    if args.num_points_per_patch is not None:
        patch["num_points_per_patch"] = args.num_points_per_patch
    if args.num_fps is not None:
        patch["num_fps"] = args.num_fps
    if args.num_scales is not None:
        patch["num_scales"] = args.num_scales
        patch["search_radius_thresholds"] = tuple(
            (args.search_radius_thresholds or (5.0, 2.0, 0.5))
            [: args.num_scales]
        )
    if args.search_radius_thresholds is not None:
        patch["search_radius_thresholds"] = tuple(
            args.search_radius_thresholds)
        patch["num_scales"] = len(args.search_radius_thresholds)
    if args.desc_mode is not None:
        patch["desc_mode"] = args.desc_mode
    match = {}
    if args.pose_estimator is not None:
        match["pose_estimator"] = args.pose_estimator
    if args.enable_early_exit:
        match["enable_early_exit"] = True
    test = {"experiment_id": args.experiment_id}
    if args.pose_refine:
        test["pose_refine"] = True
    out = cfg
    if args.fast:
        out = out.override(
            capacity=dict(
                max_points=4096, num_ransac_hypotheses=2048,
                ransac_chunk=512, sphere_query_chunk=128,
            ),
            patch=dict(
                num_fps=384, num_points_radius_estimate=512,
                num_points_per_patch=192,
            ),
        )
    if patch:
        out = out.override(patch=patch)
    if match:
        out = out.override(match=match)
    return out.override(test=test)


def synthetic_pairs(n, seed=0, num_points=20000):
    """Full-overlap synthetic pairs, pair i from ``RandomState(seed + i)``."""
    from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap

    for i in range(n):
        rs = np.random.RandomState(seed + i)
        s, t, T = synthetic_pair_full_overlap(rs, num_points=num_points)
        yield dict(
            src_points=s, tgt_points=t, relt_pose=T,
            src_id=f"synth/{i}a", tgt_id=f"synth/{i}b",
            is_aligned_to_global_z=False, dataset_name="Synthetic",
        )


def rmse_protocol(cfg, rows, out_dir, log=print):
    """Groups the estimates by scene, writes one trajectory ``.log`` a scene
    under ``out_dir/logs`` and scores each against its ``gt.log`` and
    ``gt.info`` (the JAX script's function; its unused ``args`` dropped).
    Returns the mean recall over the scored scenes, or None."""
    from bufferx_tpu_torch.data.base import (
        read_trajectory_info,
        read_trajectory_log,
        write_trajectory_log,
    )
    from bufferx_tpu_torch.eval.metrics import evaluate_registration_rmse

    per_scene = defaultdict(list)
    for r in rows:
        # src_id format: <...>/fragments/<scene>/cloud_bin_N.ply
        parts = str(r["src_id"]).split("/")
        scene = parts[-2] if len(parts) >= 2 else "scene"
        i = int(str(parts[-1]).split("_")[-1].split(".")[0])
        j = int(str(r["tgt_id"]).split("/")[-1].split("_")[-1].split(".")[0])
        per_scene[scene].append((i, j, np.linalg.inv(r["pose"])))

    recalls = []
    benchmark = cfg.benchmark or "3DMatch"
    for scene, items in per_scene.items():
        pairs = np.asarray([[i, j, 0] for i, j, _ in items])
        poses = np.stack([p for _, _, p in items])
        write_trajectory_log(
            os.path.join(out_dir, "logs", f"{scene}.log"), pairs, poses
        )
        if benchmark == "3DMatch":
            gt_dir = os.path.join(
                cfg.data.root, "test", "3DMatch", "gt_result", scene
            )
        else:
            gt_dir = os.path.join(cfg.data.root, "test", "3DLoMatch", scene)
        gt_log = os.path.join(gt_dir, "gt.log")
        gt_info = os.path.join(gt_dir, "gt.info")
        if not (os.path.exists(gt_log) and os.path.exists(gt_info)):
            continue
        gt_pairs, gts = read_trajectory_log(gt_log)
        _info_pairs, infos = read_trajectory_info(gt_info)
        n_frag = int(gt_pairs[:, 2].max()) if len(gt_pairs) else 0
        recall, _, _, _ = evaluate_registration_rmse(
            n_frag, poses, pairs[:, :2], gt_pairs[:, :2], gts, infos
        )
        recalls.append(recall)
        log(f"[rmse protocol] {scene}: recall {recall:.4f}")
    return float(np.mean(recalls)) if recalls else None


def run(argv=None, log=print) -> dict:
    """The CLI's work: returns the summary (its ``rows`` included)."""
    args = parse_args(argv)
    from bufferx_tpu_torch.config import make_cfg
    from bufferx_tpu_torch.device import resolve_device
    from bufferx_tpu_torch.eval.harness import (
        evaluate_pairs,
        evaluate_pairs_batched,
    )
    from bufferx_tpu_torch.pipeline.registration import init_params
    from bufferx_tpu_torch.tools.weights import (
        load_snapshot,
        load_snapshot_config,
    )
    from bufferx_tpu_torch.utils.result_io import (
        format_summary_table,
        write_full_results_csv,
    )

    dev = resolve_device("cpu" if args.cpu else "cuda")
    if args.dataset == "Synthetic":
        cfg = make_cfg("ModelNet40")
        pairs = synthetic_pairs(args.num_pairs, args.seed,
                                num_points=3500 if args.fast else 20000)
    else:
        from bufferx_tpu_torch.data.datasets import get_dataset

        cfg = make_cfg(args.dataset, args.root)
        src_sensor = tgt_sensor = None
        if args.hetero:
            src_sensor, tgt_sensor = args.hetero.split(":")
        ds = get_dataset(cfg, "test", src_sensor, tgt_sensor)
        pairs = iter(ds)
        if args.max_pairs:
            pairs = itertools.islice(pairs, args.max_pairs)

    cfg = apply_overrides(cfg, args)
    if args.checkpoint_dir:
        # architecture knobs recorded with the checkpoint (desc_mode,
        # desc_pool, desc_width change the weights' shapes) take precedence
        snap_over = load_snapshot_config(args.checkpoint_dir)
        if snap_over:
            cfg = cfg.override(patch=snap_over)
            log(f"snapshot config: {snap_over}")
        params = load_snapshot(args.checkpoint_dir)
        log(f"loaded staged checkpoints from {args.checkpoint_dir}")
    else:
        params = init_params(cfg, torch.Generator().manual_seed(0))

    out_dir = os.path.join(args.out_dir, args.experiment_id)
    csv_path = os.path.join(out_dir, f"{args.dataset}_per_sample.csv")
    summary_csv = os.path.join(out_dir, "summary.csv")
    if args.batched:
        summary = evaluate_pairs_batched(
            cfg, list(pairs), params, batch_size=args.batched,
            csv_path=csv_path, summary_csv_path=summary_csv, device=dev,
        )
        log(f"pairs/s (steady-state): {summary['pairs_per_second']:.2f}")
    else:
        summary = evaluate_pairs(
            cfg, pairs, params, csv_path=csv_path,
            summary_csv_path=summary_csv, log=log,
            profile_dir=args.profile_dir, progress=args.progress,
            enable_timing=args.enable_timing, device=dev,
        )
    rows = summary.pop("rows")

    # the 3DMatch protocol: trajectories and the RMSE re-scoring
    if args.dataset in ("3DMatch", "3DLoMatch") and rows:
        rmse_recall = rmse_protocol(cfg, rows, out_dir, log=log)
        if rmse_recall is not None:
            summary["rmse_recall"] = rmse_recall

    # the aggregate keyed by the ablation parameters
    extra = {}
    if args.hetero:
        extra["hetero"] = args.hetero.replace(":", "-")
    if cfg.test.pose_refine:
        extra["refine"] = 1
    if cfg.match.pose_estimator != "ransac":
        extra["solver"] = cfg.match.pose_estimator
    full_csv = write_full_results_csv(
        os.path.join(out_dir, "full_results"),
        [summary],
        args.experiment_id,
        time.strftime("%Y%m%d-%H%M%S"),
        num_points_per_patch=cfg.patch.num_points_per_patch,
        num_scales=cfg.patch.num_scales,
        num_fps=cfg.patch.num_fps,
        extra_params=extra,
    )
    log(f"full results: {full_csv}")
    log(format_summary_table([dict(summary)]))
    summary["rows"] = rows
    return summary


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
