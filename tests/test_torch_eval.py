"""The port's evaluation layer against the JAX package's: the metrics (equal
values), every ``make_cfg`` preset (field by field, for the fields the port
carries), the copied utilities (timers, result CSVs, progress line,
prefetch), and both harness functions end to end.

Harness: 3 seeded full-overlap pairs at the small size of
``test_torch_pipeline.py`` (sequential, with and without per-phase timing)
and 3 pairs at batch 2 (so the last batch is short; the JAX harness pads
it), each side with the JAX harness's own draws. The per-sample CSVs agree
column by column except the time columns: ids, dataset, success and
``scales_used`` equal; RTE within 0.02 m and RRE within 2 degrees (the
port's pose tolerance); the inlier, mutual and consensus counts within 10%
+ 3 (bf16 descriptors flip a few matches; measured: 31 against 28 at
most).
"""

import csv
import dataclasses
import io
import os
import threading

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu import config as jconfig
from bufferx_tpu.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu.eval import harness as jharness
from bufferx_tpu.eval import metrics as jmetrics
from bufferx_tpu.utils import progress as jprogress
from bufferx_tpu_torch import config as tconfig
from bufferx_tpu_torch.data.prefetch import prefetch_indexed, prefetch_iter
from bufferx_tpu_torch.eval import harness as tharness
from bufferx_tpu_torch.eval import metrics as tmetrics
from bufferx_tpu_torch.pipeline import registration as treg
from bufferx_tpu_torch.tools.weights import load_snapshot
from bufferx_tpu_torch.utils import progress as tprogress
from bufferx_tpu_torch.utils.result_io import (
    PER_SAMPLE_COLUMNS,
    format_summary_table,
    write_per_sample_csv,
    write_summary_csv,
)
from bufferx_tpu_torch.utils.timers import AverageMeter, DeviceTimer, Timer
from test_torch_pipeline import SMALL, SNAP, _jax_draws, few_threads  # noqa: F401

TIME_COLUMNS = {"data_time", "model_time", "desc_time", "pose_time",
                "pose_optim_time"}


# ---- metrics ---------------------------------------------------------------
def _rotations(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        q = rs.randn(4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        out.append(np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]))
    # the branches of Shepperd's method: identity, half turns about x, y, z
    out += [np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
            np.diag([-1.0, -1, 1])]
    return out


def test_mat2quat_and_transformation_error_equal():
    rs = np.random.RandomState(1)
    for R in _rotations(12, 0):
        assert np.array_equal(tmetrics.mat2quat(R), jmetrics.mat2quat(R))
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, rs.randn(3) * 0.1
        a = rs.randn(6, 6)
        info = a @ a.T + np.eye(6)
        assert (tmetrics.transformation_error(T, info)
                == jmetrics.transformation_error(T, info))


def test_evaluate_registration_rmse_equal():
    rs = np.random.RandomState(7)
    n_frag = 12
    gt_pairs, gts, infos = [[0, 1]], [np.eye(4)], [np.eye(6)]
    for i in range(n_frag):
        for j in range(i + 2, min(i + 6, n_frag)):
            gt_pairs.append([i, j])
            T = np.eye(4)
            T[:3, :3] = _rotations(1, i * 31 + j)[0]
            T[:3, 3] = rs.randn(3)
            gts.append(T)
            a = rs.randn(6, 6)
            infos.append(a @ a.T + np.eye(6) * 50)
    gt_pairs, gts, infos = np.asarray(gt_pairs), np.stack(gts), np.stack(infos)
    est = gts.copy()
    est[:, :3, 3] += rs.randn(len(gts), 3) * 0.15
    result_pairs = np.concatenate([gt_pairs, [[3, 4], [0, 11]]])
    est = np.concatenate([est, np.stack([np.eye(4)] * 2)])
    t = tmetrics.evaluate_registration_rmse(n_frag, est, result_pairs,
                                            gt_pairs, gts, infos)
    j = jmetrics.evaluate_registration_rmse(n_frag, est, result_pairs,
                                            gt_pairs, gts, infos)
    assert t[0] == j[0] and t[1] == j[1] and t[2] == j[2]
    assert np.array_equal(t[3], j[3], equal_nan=True)
    assert 0 < t[0] < 1 and 2 in t[2]


def test_pairwise_recall_equal():
    rs = np.random.RandomState(3)
    rte, rre = rs.uniform(0, 0.6, 50), rs.uniform(0, 30, 50)
    t = tmetrics.pairwise_recall(rte, rre, 0.3, 15.0)
    j = jmetrics.pairwise_recall(rte, rre, 0.3, 15.0)
    assert np.array_equal(t[0], j[0]) and t[1] == j[1]
    assert tmetrics.pairwise_recall([], [], 0.3, 15.0)[1] == 0.0


# ---- presets ---------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(jconfig.DATASETS))
def test_presets_equal_jax(name):
    """All 14 presets, every field of every section."""
    assert sorted(tconfig.DATASETS) == sorted(jconfig.DATASETS)
    t, j = tconfig.make_cfg(name, "/data"), jconfig.make_cfg(name, "/data")
    for sec in ("data", "train", "test", "optim", "patch", "match",
                "capacity"):
        for f in dataclasses.fields(getattr(t, sec)):
            assert getattr(getattr(t, sec), f.name) == \
                getattr(getattr(j, sec), f.name), (sec, f.name)
    assert (t.stage, t.benchmark) == (j.stage, j.benchmark)


def test_unknown_preset_names_the_choices():
    with pytest.raises(ValueError, match="3DLoMatch"):
        tconfig.make_cfg("NoSuchDataset")


# ---- utilities -------------------------------------------------------------
def test_timers_and_meter():
    m = AverageMeter()
    for v in (1.0, 2.0, 3.0, 4.0):
        m.update(v)
    assert (m.avg, m.count, m.min, m.max) == (2.5, 4, 1.0, 4.0)
    assert abs(m.std - np.std([1, 2, 3, 4])) < 1e-12
    t = Timer()
    t.tic()
    assert t.toc(average=False) >= 0 and t.calls == 1
    dt = DeviceTimer("cpu")          # no fence on the CPU
    with dt:
        sum(range(1000))
    with dt:
        pass
    assert dt.calls == 2 and dt.diff >= 0 and dt.avg >= 0


def test_result_io(tmp_path):
    rows = [dict(src_id=i, tgt_id=i + 1, success=1, rte=0.1, rre=1.0,
                 num_inliers=5, num_mutual_inliers=6, num_inlier_ind=7,
                 scales_used=3, data_time=0.0, model_time=0.1, desc_time=0,
                 pose_time=0, pose_optim_time=0, dataset="x",
                 pose=np.eye(4)) for i in range(3)]
    path = write_per_sample_csv(str(tmp_path / "a" / "s.csv"), rows)
    with open(path) as f:
        got = list(csv.DictReader(f))
    assert list(got[0]) == PER_SAMPLE_COLUMNS and len(PER_SAMPLE_COLUMNS) == 15
    assert [r["src_id"] for r in got] == ["0", "1", "2"]
    summ = str(tmp_path / "sum.csv")
    write_summary_csv(summ, dict(recall=0.5, n=2))
    write_summary_csv(summ, dict(recall=0.75, n=4))
    with open(summ) as f:
        assert [r["recall"] for r in csv.DictReader(f)] == ["0.5", "0.75"]
    table = format_summary_table([dict(dataset="3DMatch", recall=0.5)])
    assert "| 3DMatch" in table and "0.5000" in table


def test_progress_names_equal_jax():
    for name in list(jconfig.DATASETS) + ["Synthetic", "Other"]:
        assert tprogress.display_name(name) == jprogress.display_name(name)
    assert tprogress.display_name("KITTI", "a", "b") == "KITTI a->b"
    stream = io.StringIO()
    line = tprogress.ProgressLine("3DMatch", total=2, stream=stream)
    line.update(0, 1.0, 0.1, 1.0, True)
    line.update(1, 0.5, 0.5, 20.0, False, pair_id="p1")
    line.finish()
    err = stream.getvalue()
    assert "[fail] 3DMatch p1" in err and "[2/2]" in err


def test_prefetch_order_and_errors():
    assert list(prefetch_indexed(lambda i: i * i, 17, num_workers=3,
                                 depth=5)) == [i * i for i in range(17)]
    assert list(prefetch_iter(iter(range(23)), depth=3)) == list(range(23))

    def gen():
        yield 1
        raise RuntimeError("source died")

    with pytest.raises(RuntimeError, match="source died"):
        list(prefetch_iter(gen(), depth=2))
    # abandoning the iterator stops its filler thread
    before = threading.active_count()
    it = prefetch_iter(iter(range(1000)), depth=2)
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


# ---- the harness against the JAX harness -----------------------------------
@pytest.fixture(scope="module")
def world():
    jcfg = jconfig.make_cfg("ModelNet40").override(**SMALL)
    tcfg = tconfig.make_cfg("ModelNet40").override(**SMALL)
    params = {}
    for stage in ("Desc", "Pose"):
        with open(os.path.join(SNAP, stage, "best.msgpack"), "rb") as f:
            params[stage.lower()] = jax.tree.map(
                jnp.asarray, flax.serialization.msgpack_restore(f.read()))
    models = treg.build_models(treg.PipelineStatics.from_config(tcfg),
                               load_snapshot(SNAP), "cpu")
    samples = []
    for i in range(3):
        s, t, T = synthetic_pair_full_overlap(np.random.RandomState(40 + i),
                                              2000)
        samples.append(dict(src_points=s, tgt_points=t, relt_pose=T,
                            src_id=f"s{i}", tgt_id=f"t{i}",
                            is_aligned_to_global_z=False))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, models=models,
                samples=samples,
                jst=jharness.PipelineStatics.from_config(jcfg))


def _read(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _same_rows(trows, jrows):
    assert len(trows) == len(jrows)
    for t, j in zip(trows, jrows):
        assert list(t) == list(j) == PER_SAMPLE_COLUMNS
        for col in PER_SAMPLE_COLUMNS:
            if col in TIME_COLUMNS:
                continue
            if col in ("src_id", "tgt_id", "dataset", "success",
                       "scales_used"):
                assert t[col] == j[col], col
            elif col == "rte":
                assert abs(float(t[col]) - float(j[col])) <= 0.02
            elif col == "rre":
                assert abs(float(t[col]) - float(j[col])) <= 2.0
            else:
                assert abs(int(t[col]) - int(j[col])) <= \
                    0.1 * int(j[col]) + 3, (col, t[col], j[col])


@pytest.mark.parametrize("timing", [False, True])
def test_evaluate_pairs_matches_jax(world, tmp_path, timing):
    key = jax.random.PRNGKey(world["jcfg"].data.manual_seed)
    draws = []
    for _ in world["samples"]:
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, world["jst"])[1])
    jsum = jharness.evaluate_pairs(
        world["jcfg"], world["samples"], world["params"],
        csv_path=str(tmp_path / "j.csv"), prefetch_workers=0,
        enable_timing=timing)
    tsum = tharness.evaluate_pairs(
        world["tcfg"], world["samples"], world["models"],
        csv_path=str(tmp_path / "t.csv"),
        summary_csv_path=str(tmp_path / "ts.csv"), enable_timing=timing,
        draws=draws, device="cpu")
    _same_rows(_read(tmp_path / "t.csv"), _read(tmp_path / "j.csv"))
    assert set(tsum) == set(jsum)
    assert tsum["recall"] == jsum["recall"] == 1.0
    assert tsum["num_pairs"] == 3
    if timing:   # the phases are measured, and beside the whole
        for r in tsum["rows"]:
            assert r["desc_time"] > 0 and r["pose_time"] > 0
            assert r["pose_optim_time"] == 0.0     # ModelNet40: no IRLS
            assert r["desc_time"] + r["pose_time"] <= r["model_time"]
    assert list(_read(tmp_path / "ts.csv")[0]) == \
        [k for k in tsum if k != "rows"]


def test_evaluate_pairs_batched_matches_jax(world, tmp_path):
    key = jax.random.PRNGKey(world["jcfg"].data.manual_seed)
    draws = []
    for b in range(2):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, 2)
        draws.append(treg.stack_draws([_jax_draws(keys[j], world["jst"])[1]
                                       for j in range(2 if b == 0 else 1)]))
    jsum = jharness.evaluate_pairs_batched(
        world["jcfg"], world["samples"], world["params"], batch_size=2,
        prefetch_workers=0, csv_path=str(tmp_path / "j.csv"))
    tsum = tharness.evaluate_pairs_batched(
        world["tcfg"], world["samples"], world["models"], batch_size=2,
        csv_path=str(tmp_path / "t.csv"), draws=draws, device="cpu")
    _same_rows(_read(tmp_path / "t.csv"), _read(tmp_path / "j.csv"))
    assert set(tsum) == set(jsum)
    assert tsum["num_pairs"] == 3 and tsum["recall"] == jsum["recall"]
    assert tsum["pairs_per_second"] > 0
    # every row of a batch carries the batch's time over its real size
    rows = tsum["rows"]
    assert rows[0]["model_time"] == rows[1]["model_time"] > 0
    assert rows[2]["model_time"] > 0


def _gravity_pair(seed: int, n: int = 2000):
    """A full-overlap pair whose ground truth turns about z alone (a
    gravity-aligned pair): ``synthetic_pair_full_overlap``'s object and
    noise under a yaw and a translation."""
    from bufferx_tpu.data.modelnet import synthetic_object

    rs = np.random.RandomState(seed)
    obj = synthetic_object(rs, n)
    a = rs.uniform(0.0, 2.0 * np.pi)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                 [0.0, 0.0, 1.0]]
    T[:3, 3] = rs.uniform(-0.5, 0.5, 3)
    src = (obj + rs.randn(*obj.shape) * 0.002).astype(np.float32)
    tgt = (obj @ T[:3, :3].T + T[:3, 3]
           + rs.randn(*obj.shape) * 0.002).astype(np.float32)
    return src, tgt, T


def test_batched_refuses_mixed_alignment(world, tmp_path):
    """A batch whose pairs differ in ``is_aligned_to_global_z`` (a pair
    with a general rotation, False; a gravity-aligned pair, True) against
    the JAX harness, which maps the flag per pair, with its draws: rows
    within the tolerances of ``_same_rows``. Each of the port's pairs equals
    ``register_batch`` on the same clouds and draws with its flag as one
    Python bool for the batch (the bool branch), to the bit, and the
    aligned pair's pose moves when its flag does."""
    s0, t0, T0 = synthetic_pair_full_overlap(np.random.RandomState(44), 2000)
    s1, t1, T1 = _gravity_pair(45)
    samples = [dict(src_points=s, tgt_points=t, relt_pose=T, src_id=f"m{i}",
                    tgt_id=f"n{i}", is_aligned_to_global_z=flag)
               for i, (s, t, T, flag) in enumerate(((s0, t0, T0, False),
                                                    (s1, t1, T1, True)))]
    key = jax.random.PRNGKey(world["jcfg"].data.manual_seed)
    _key, sub = jax.random.split(key)
    keys = jax.random.split(sub, 2)
    draws = treg.stack_draws([_jax_draws(keys[j], world["jst"])[1]
                              for j in range(2)])
    jsum = jharness.evaluate_pairs_batched(
        world["jcfg"], samples, world["params"], batch_size=2,
        prefetch_workers=0, csv_path=str(tmp_path / "j.csv"))
    tsum = tharness.evaluate_pairs_batched(
        world["tcfg"], samples, world["models"], batch_size=2,
        prefetch_workers=0, csv_path=str(tmp_path / "t.csv"), draws=[draws],
        device="cpu")
    _same_rows(_read(tmp_path / "t.csv"), _read(tmp_path / "j.csv"))
    assert tsum["recall"] == jsum["recall"] == 1.0

    tcfg = world["tcfg"]
    srcs = [treg.prepare_cloud(s["src_points"], tcfg, seed=2 * i,
                               device="cpu") for i, s in enumerate(samples)]
    tgts = [treg.prepare_cloud(s["tgt_points"], tcfg, seed=2 * i + 1,
                               device="cpu") for i, s in enumerate(samples)]
    single = {flag: treg.register_batch(tcfg, srcs, tgts, world["models"],
                                        draws=draws, is_aligned=flag,
                                        device="cpu").pose
              for flag in (False, True)}
    for i, flag in enumerate((False, True)):
        assert np.array_equal(tsum["rows"][i]["pose"],
                              single[flag][i].numpy()), i
    assert not torch.equal(single[False][1], single[True][1])


def test_harness_runs_on_the_card_by_default(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tharness.evaluate_pairs(world["tcfg"], world["samples"][:1],
                                world["models"])
    with pytest.raises(RuntimeError):
        tharness.evaluate_pairs_batched(world["tcfg"], world["samples"][:1],
                                        world["models"])
