"""Evaluation result output: per-sample CSV, aggregate CSV, summary table.

Keeps the reference's output contract (its ``utils/result_io.py``):
a per-sample CSV with timing decomposition, an aggregate CSV keyed by config
parameters, and a grid-formatted console summary.
"""

from __future__ import annotations

import csv
import os
from typing import Sequence

__all__ = [
    "write_per_sample_csv",
    "write_summary_csv",
    "write_full_results_csv",
    "format_summary_table",
]

PER_SAMPLE_COLUMNS = [
    "src_id",
    "tgt_id",
    "success",
    "rte",
    "rre",
    "num_inliers",
    "num_mutual_inliers",
    "num_inlier_ind",
    "scales_used",
    "data_time",
    "model_time",
    "desc_time",
    "pose_time",
    "pose_optim_time",
    "dataset",
]


def write_per_sample_csv(path: str, rows: Sequence[dict]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=PER_SAMPLE_COLUMNS, extrasaction="ignore")
        writer.writeheader()
        for row in rows:
            writer.writerow(row)
    return path


def write_summary_csv(path: str, summary: dict) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(summary.keys()))
        if not exists:
            writer.writeheader()
        writer.writerow(summary)
    return path


def write_full_results_csv(
    out_dir: str,
    summaries: Sequence[dict],
    experiment_id: str,
    timestr: str,
    *,
    num_points_per_patch: int,
    num_scales: int,
    num_fps: int,
    extra_params: dict | None = None,
) -> str:
    """Config-parameter-keyed aggregate CSV (one file per sweep setting).

    The ablation parameters live in the FILENAME
    (``results_<exp>_<patch>_<scales>_<fps>[_k=v...]_<time>.csv``) and
    every row carries ``experiment_id`` + ``timestamp`` columns, so sweep
    outputs never silently mix configurations (reference
    ``utils/result_io.py:80-124``). ``extra_params`` appends further
    ``k=v`` tokens (e.g. hetero ``src:tgt`` specs, pose_refine).
    """
    os.makedirs(out_dir, exist_ok=True)
    exp_name = experiment_id.rsplit("/", 1)[-1]
    tokens = [exp_name, str(num_points_per_patch), str(num_scales),
              str(num_fps)]
    for k, v in sorted((extra_params or {}).items()):
        tokens.append(f"{k}={v}")
    path = os.path.join(
        out_dir, "results_" + "_".join(tokens) + f"_{timestr}.csv"
    )
    if not summaries:
        cols = ["experiment_id", "timestamp"]
    else:
        cols = [c for c in summaries[0].keys() if c != "rows"]
        cols += ["experiment_id", "timestamp"]
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
        writer.writeheader()
        for s in summaries:
            row = {k: v for k, v in s.items() if k != "rows"}
            row["experiment_id"] = experiment_id
            row["timestamp"] = timestr
            writer.writerow(row)
    return path


def format_summary_table(summaries: Sequence[dict]) -> str:
    """Grid-formatted summary like the reference's tabulate output."""
    if not summaries:
        return "(no results)"
    cols = list(summaries[0].keys())
    widths = {
        c: max(len(str(c)), *(len(_fmt(s.get(c, ""))) for s in summaries))
        for c in cols
    }
    sep = "+" + "+".join("-" * (widths[c] + 2) for c in cols) + "+"
    header = "|" + "|".join(f" {c:<{widths[c]}} " for c in cols) + "|"
    lines = [sep, header, sep]
    for s in summaries:
        lines.append(
            "|" + "|".join(f" {_fmt(s.get(c, '')):<{widths[c]}} " for c in cols) + "|"
        )
    lines.append(sep)
    return "\n".join(lines)


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)
