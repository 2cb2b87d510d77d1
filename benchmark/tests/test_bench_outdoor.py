"""The outdoor cell ``kitti.lidar.b8`` on the CPU: the LiDAR street-scan
generator's properties, its frozen ingest against the program's, the
configuration file as the program derives it, a tiny copy of the cell
through the whole run (a sound run is correct, the planted faults are
not), the RANSAC readers against a program without their span and
counter, and the kernel counts left at K1-K5.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import pytest
import torch

from benchmark.generators import lidar_street
from benchmark.harness import (
    ROOT,
    Run,
    count_modules,
    load_module,
    metrics_for,
    program_config,
    run_cell,
)
from benchmark.seeding import random_state
from benchmark.tests.conftest import (
    TINY_OVERRIDES,
    tiny_copy,
    tiny_statics,
    write_json,
)
from benchmark.tests.test_bench_reference import FAULTS

CELL = "kitti.lidar.b8"
SEED = 2 ** 33 + 17
# small scans for the generator's properties: two scenes, a pair of every
# separation drawn, 16 beams
SMALL = dict(scenes=2, pairs_per_scene=4, beams=16, azimuth_steps=512,
             block=4)
# the tiny cell: one scene's four pairs, 4 m apart within 15 m of range,
# so that 2048 points a cloud still find a few inliers
TINY_SCANS = dict(scenes=1, pairs_per_scene=4, beams=32, azimuth_steps=512,
                  max_range=15.0, spacing=2.0, separation=[4.0, 4.0],
                  max_num_pts=4000, block=2)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def _params(**kw) -> dict:
    return dict(_json("benchmark", "traffic", "lidar_b8.json")["params"],
                **kw)


@pytest.fixture(scope="module")
def small():
    params = _params(**SMALL)
    return params, lidar_street.fixed_pairs(params)


def test_fixed_set_is_deterministic_by_key(small):
    params, fixed = small
    again = lidar_street.fixed_pairs(params)
    other = lidar_street.fixed_pairs(dict(params, scene_key=1))
    assert len(fixed) == len(again) == 8
    for a, b in zip(fixed, again):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert any(a[0].shape != b[0].shape or not np.array_equal(a[0], b[0])
               for a, b in zip(fixed, other))


def test_pairs_are_ten_to_twenty_metres_apart_and_level(small):
    """The sensors' separation lies in [10, 20] m, pair k of every scene
    comes before pair k + 1 of any, and ``T_gt`` turns about z within the
    two scans' tilts (each at most ``tilt_deg`` of roll and of pitch)."""
    params, fixed = small
    tilt = 2.0 * math.sqrt(2.0) * params["tilt_deg"]
    for src, tgt, t_gt in fixed:
        assert 10.0 - 1e-4 <= np.linalg.norm(t_gt[:3, 3]) <= 20.0 + 1e-4
        z = t_gt[:3, 2].astype(np.float64)
        assert math.degrees(math.acos(min(z[2], 1.0))) <= tilt + 1e-3
        assert 0.0 < len(src) <= params["max_num_pts"]
        assert src.dtype == tgt.dtype == t_gt.dtype == np.float32
    # with the ground truth, the pair's clouds meet: most source points
    # lie within half a metre of a target point
    from scipy.spatial import cKDTree

    src, tgt, t_gt = fixed[0]
    moved = src.astype(np.float64) @ t_gt[:3, :3].T + t_gt[:3, 3]
    near = cKDTree(tgt).query(moved, distance_upper_bound=0.5)[0] < 0.5
    assert near.mean() > 0.3


def test_the_seed_moves_targets_about_z_alone(small):
    params, fixed = small
    moved = lidar_street.reorder_and_move(
        SEED, fixed, params["max_trans_xy"], params["max_trans_z"],
        params["block"])
    index = {a[0].tobytes(): i for i, a in enumerate(fixed)}
    seen = []
    for src, tgt, t_gt in moved:
        seen.append(index[src.tobytes()])
        _src, f_tgt, f_gt = fixed[seen[-1]]
        m = t_gt.astype(np.float64) @ np.linalg.inv(f_gt.astype(np.float64))
        np.testing.assert_allclose(m[2, :3], [0.0, 0.0, 1.0], atol=1e-5)
        np.testing.assert_allclose(m[:3, 2], [0.0, 0.0, 1.0], atol=1e-5)
        assert np.all(np.abs(m[:2, 3]) <= params["max_trans_xy"] + 1e-3)
        assert abs(m[2, 3]) <= params["max_trans_z"] + 1e-3
        np.testing.assert_allclose(
            tgt, f_tgt.astype(np.float64) @ m[:3, :3].T + m[:3, 3],
            atol=1e-3)
    # shuffled within blocks only
    block = params["block"]
    assert [s // block for s in seen] == [k // block
                                          for k in range(len(fixed))]


def test_full_scans_have_a_velodyne_s_returns():
    """At the cell's scanner (64 beams, 2048 steps): the median scan of
    the sixteen scenes' middle positions holds 100-120k returns,
    every one at least half the 131072 rays, within the scanner's ranges,
    mounted at its height above the road."""
    params = _params()
    counts = []
    for s in range(params["scenes"]):
        scene = lidar_street.make_scene(
            random_state(params["scene_key"], "lidar_street.scene", s),
            params)
        for k in (4,):
            pts, pose = lidar_street.scan(
                scene, k, random_state(params["scene_key"],
                                       "lidar_street.scan", s * 1000 + k),
                params)
            counts.append(len(pts))
            r = np.linalg.norm(pts, axis=1)
            assert r.min() >= params["min_range"] - 0.1
            assert r.max() <= params["max_range"] + 0.1
            ground = pose[0, 3] * math.tan(math.radians(params["grade_deg"]))
            assert abs(pose[2, 3] - params["height"]) <= abs(ground) + 1e-6
    assert 100_000 <= np.median(counts) <= 120_000, counts
    assert min(counts) >= 64 * 2048 // 2, counts


def test_ingest_equals_the_programs():
    from bufferx_tpu_torch.geometry import sphericity
    from bufferx_tpu_torch.kernels import voxel

    rs = np.random.RandomState(3)
    a = (rs.rand(5000, 3) * [80, 30, 6]).astype(np.float32)
    b = (rs.rand(4000, 3) * [80, 30, 8]).astype(np.float32)
    assert lidar_street.sphericity_based_voxel_analysis(
        a, b, np.random.RandomState(1)) == \
        sphericity.sphericity_based_voxel_analysis(
            a, b, np.random.RandomState(1))
    for size in (0.03, 0.3):
        np.testing.assert_array_equal(
            lidar_street.voxel_downsample_np(a, size),
            voxel.voxel_downsample_np(a, size))


def test_the_configuration_file_is_the_programs():
    spec = _json("BENCHMARK.json")
    config = _json("benchmark", "configs", "kitti_sampled.json")
    entry = {c["name"]: c for c in spec["configs"]}["kitti_sampled"]
    assert entry["reduced"] == [] and config["reduced"] == []
    assert entry["source"] == config["source"]
    assert len(entry["source"]) <= 200
    cfg = program_config(config)
    assert cfg.data.dataset == "KITTI" and cfg.patch.is_aligned_to_global_z
    assert config["statics"]["num_hypotheses"] == 50000
    cell = {w["name"]: w for w in spec["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "kitti_sampled", "lidar_b8", 1)
    cells = [w["name"] for w in spec["workloads"]]
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in ("stage_ms.ransac", "ransac_hypotheses_per_pair"):
        assert per_layer[name]["workloads"] == cells
        assert per_layer[name]["layer"] == "pose solver"
    # the batched cells' shared per-layer metrics list the cell too; the
    # online cell's and the gate's own ones do not
    assert {m["name"] for m in metrics_for(spec, CELL, True)} == {
        "stage_ms.ransac", "ransac_hypotheses_per_pair", "redo_share",
        "launches_per_pair", "kernel_roofline_share", "step_mfu",
        "device_idle_share", "stage_ms.precompute", "stage_ms.candidates",
        "stage_ms.describe", "stage_ms.solve", "idle_share.ingest",
        "idle_share.dispatch", "host_syncs_per_pair"}


def test_the_counts_are_k1_to_k5():
    assert set(count_modules()) == {"fps", "strat", "moments",
                                    "cell_query", "conv_stack"}


def _kitti_copy(tmp_path) -> tuple:
    """A tiny copy of the cell: the KITTI configuration at the tests' tiny
    widths (300 hypotheses in chunks of 128), the scans above, under the
    cell's own check."""
    bench, root = tiny_copy(tmp_path, config_name="tiny_sampled",
                            rules=_json("benchmark", "checks",
                                        CELL + ".json"))
    base = _json("benchmark", "configs", "kitti_sampled.json")
    over = {"patch": dict(base["overrides"]["patch"],
                          **TINY_OVERRIDES["patch"]),
            "capacity": dict(TINY_OVERRIDES["capacity"],
                             num_ransac_hypotheses=300)}
    write_json(os.path.join(bench, "configs", "tiny_sampled.json"),
               dict(base, name="tiny_sampled", overrides=over,
                    statics=tiny_statics(base["preset"], over)))
    traffic = _json("benchmark", "traffic", "lidar_b8.json")
    traffic["params"].update(TINY_SCANS)
    traffic["entry_params"] = {"pairs_per_call": 4, "batch_size": 2,
                               "warm_calls": 0, "trace_calls": 1,
                               "check_batches": 2}
    write_json(os.path.join(bench, "traffic", "tiny.json"),
               dict(traffic, name="tiny"))
    return bench, root


def test_a_sound_tiny_run_is_correct(tmp_path):
    bench, root = _kitti_copy(tmp_path)
    result, _ = run_cell("tiny.cell", SEED, 0.01, True, time.perf_counter(),
                         bench=bench, root=root, need_cuda=False)
    assert result["correct"] is True
    assert all(j["value"] == 0.0 for j in result["check"].values())
    metrics = result["metrics"]
    # 300 hypotheses a pair in phase 1 and again for each redone pair
    redo = metrics["redo_share"]["value"] / 100.0
    assert metrics["ransac_hypotheses_per_pair"]["value"] == pytest.approx(
        300 * (1 + redo))
    assert metrics["stage_ms.ransac"]["value"] > 0.0
    assert metrics["stage_ms.ransac"]["value"] <= \
        metrics["stage_ms.solve"]["value"]


def _moved_past_success(reg):
    """An answer altered where it is produced, at the cell's scale: every
    solved pose moved 2.5 m along x, past the preset's 2 m success
    distance (the accepted cells' 5 cm lies within the sound gaps of scans
    100 m wide)."""
    pool_and_solve = reg._pool_and_solve

    def broken(*a, **kw):
        res = pool_and_solve(*a, **kw)
        pose = res.pose.clone()
        pose[:, 0, 3] += 2.5
        return res._replace(pose=pose)
    reg._pool_and_solve = broken


KITTI_FAULTS = dict(
    {name: FAULTS[name] for name in ("identity_pose", "half_batch",
                                     "no_redo", "altered_matches",
                                     "one_pair_wrong")},
    moved_past_success=_moved_past_success)


@pytest.mark.parametrize("fault", list(KITTI_FAULTS))
def test_a_broken_tiny_run_is_not_correct(tmp_path, fault):
    import bufferx_tpu_torch.pipeline.registration as reg

    saved = dict(vars(reg))
    bench, root = _kitti_copy(tmp_path)
    try:
        result, _ = run_cell("tiny.cell", SEED, 0.01, False,
                             time.perf_counter(), bench=bench, root=root,
                             need_cuda=False,
                             program_hook=KITTI_FAULTS[fault])
    finally:
        for k, v in saved.items():
            setattr(reg, k, v)
    assert result["correct"] is False


def test_the_ransac_readers_without_the_programs_span_and_counter(
        monkeypatch):
    """Against a revision of the program that has neither: both
    readers give None and raise nothing."""
    from bufferx_tpu_torch.utils import timers

    run = Run(workload=CELL, seed=SEED, statics={}, traffic={})
    run.traced_records = [object()] * 4
    run._program_spans = [timers.SpanRecord("bufferx.solve", 2, None, 2, 4,
                                            1.0, 3.0)]
    monkeypatch.delattr(timers, "counters")
    assert load_module("metrics", "stage_ms.ransac").read(run) is None
    assert load_module("metrics",
                       "ransac_hypotheses_per_pair").read(run) is None
