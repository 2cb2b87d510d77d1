"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with tiny
cells, run on the CPU with the program's plain kernels.

The card is decided inside the ``card`` fixture, never while a module is
imported; tests marked ``chip`` take it and skip without a card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import pytest

from benchmark.harness import BENCH, ROOT

TINY_OVERRIDES = {
    "capacity": {"max_points": 2048, "num_ransac_hypotheses": 256,
                 "ransac_chunk": 128},
    "patch": {"num_fps": 32, "num_points_radius_estimate": 48,
              "num_points_per_patch": 64},
}
# the tiny pairs' solves find 0-3 inliers where the cells' find hundreds, so
# every tiny pair counts as confident
TINY_CONFIDENT = 0
TINY_MIX = {"count": 4, "num_points": 1500, "overlap": [0.5, 0.75],
            "noise": [0.0, 0.005], "density": [1.0, 2.0], "scene_key": 7,
            "max_trans": 1.0, "block": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the test runs on the chip")
    return torch.device("cuda", 0)


def tiny_statics(preset: str, overrides: dict) -> dict:
    from bufferx_tpu_torch.config import make_cfg
    from bufferx_tpu_torch.pipeline.registration import PipelineStatics

    cfg = make_cfg(preset).override(**overrides)
    s = dataclasses.asdict(PipelineStatics.from_config(cfg))
    s["is_aligned"] = cfg.patch.is_aligned_to_global_z
    return json.loads(json.dumps(s))


def write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_copy(tmp_path, entry="batched", config_name="tiny_moments",
              rules=None) -> tuple:
    """A copy of the benchmark under ``tmp_path`` with one tiny cell
    ``tiny.cell``: (bench dir, root dir). ``rules`` are the check's far
    thresholds and limits (a cell's ``checks`` file); a tiny pair counts as
    confident from ``TINY_CONFIDENT`` inliers. The root links the
    repository's snapshots."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "snapshot"), root / "snapshot")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    base = json.load(open(bench / "configs" / "modelnet40_moments.json"))
    overrides = {"patch": dict(base["overrides"]["patch"],
                               **TINY_OVERRIDES["patch"]),
                 "capacity": TINY_OVERRIDES["capacity"]}
    if config_name == "tiny_sampled":
        base = json.load(open(bench / "configs" / "threedmatch_sampled.json"))
        overrides = {"patch": dict(base["overrides"]["patch"],
                                   **TINY_OVERRIDES["patch"]),
                     "capacity": TINY_OVERRIDES["capacity"]}
    config = dict(base, name=config_name, overrides=overrides,
                  statics=tiny_statics(base["preset"], overrides))
    write_json(bench / "configs" / f"{config_name}.json", config)
    entry_params = ({"pairs_per_call": 4, "batch_size": 2,
                     "warm_calls": 0, "trace_calls": 1, "check_batches": 2}
                    if entry == "batched" else
                    {"warm_calls": 0, "trace_calls": 2,
                     "check_requests": 4, "stage_requests": 1})
    write_json(bench / "traffic" / "tiny.json", {
        "name": "tiny", "why": "tiny", "generator": "hard_mixed",
        "params": TINY_MIX, "entry": entry, "entry_params": entry_params,
        "success": {"rte_m": 0.3, "rre_deg": 15.0}})
    rules = rules or {"far": {"rot_deg": 15.0, "trans_m": 0.3},
                      "limits": {"mutual_gap.median": 0.025}}
    write_json(bench / "checks" / "tiny.cell.json", {
        "confident_inliers": TINY_CONFIDENT, "far": rules["far"],
        "limits": rules["limits"]})
    spec["workloads"] = [{"name": "tiny.cell", "config": config_name,
                          "traffic": "tiny", "chips": 1, "why": "tiny"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    write_json(root / "BENCHMARK.json", spec)
    return str(bench), str(root)
