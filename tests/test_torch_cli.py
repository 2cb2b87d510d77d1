"""The port's dataset entry points against the JAX scripts.

- ``tools/evaluate.py``: ``apply_overrides`` gives ``scripts/evaluate.py``'s
  configuration field by field for every flag (the script is imported as a
  module, its ``main`` not run); the CLI on a small 3DMatch test layout
  (two fragment pairs, ``--fast``, on the CPU) writes the per-sample CSV
  with the JAX script's columns, ``summary.csv``, the ``full_results`` CSV,
  one trajectory ``.log`` a scene and the RMSE recall; ``rmse_protocol``
  writes the JAX function's ``.log`` files and recall from the same rows.
- ``evaluate_pairs``' ``log``, ``profile_dir`` and ``progress``, all on in
  one run of 10 tiny pairs: one log line at the 10th pair, a Chrome trace
  of the pair at ``WARMUP``, and the progress line.
- ``tools/train.py --cpu`` on a small 3DMatch train/val layout at reduced
  capacities: one epoch of two steps a stage; its snapshots load in the JAX
  package's ``load_params``.
"""

import csv
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from bufferx_tpu.config import make_cfg as jax_make_cfg
from bufferx_tpu.pipeline.registration import init_params as jax_init_params
from bufferx_tpu.train.trainer import load_params as jax_load_params
from bufferx_tpu.utils import result_io as jax_result_io
from bufferx_tpu_torch import config as tconfig
from bufferx_tpu_torch.data import base as tbase
from bufferx_tpu_torch.data import io as tio
from bufferx_tpu_torch.data import splits
from bufferx_tpu_torch.eval import harness
from bufferx_tpu_torch.tools import evaluate as tevaluate
from bufferx_tpu_torch.tools import train as ttrain
from test_torch_pipeline import SNAP, few_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SECTIONS = ("data", "train", "test", "optim", "patch", "match", "capacity")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_config(t, j):
    for sec in SECTIONS:
        for f in dataclasses.fields(getattr(t, sec)):
            assert getattr(getattr(t, sec), f.name) == \
                getattr(getattr(j, sec), f.name), f"{sec}.{f.name}"
    assert t.benchmark == j.benchmark


FLAGS = [
    [],
    ["--fast"],
    ["--num-points-per-patch", "1024", "--num-fps", "900"],
    ["--num-scales", "2"],
    ["--num-scales", "2", "--search-radius-thresholds", "4", "1"],
    ["--search-radius-thresholds", "5", "2", "0.5", "0.2"],
    ["--desc-mode", "sampled", "--pose-estimator", "gnc"],
    ["--pose-refine", "--enable-early-exit", "--experiment-id", "x"],
    ["--fast", "--num-points-per-patch", "128", "--batched", "8",
     "--enable-timing", "--progress", "--max-pairs", "3", "--seed", "5",
     "--hetero", "a:b", "--profile-dir", "p", "--out-dir", "o", "--cpu"],
]


@pytest.mark.parametrize("dataset", ["3DMatch", "KITTI", "Synthetic"])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: " ".join(f) or "none")
def test_apply_overrides_equal_the_jax_script(dataset, flags, monkeypatch):
    jscript = _jax_script("evaluate")
    argv = ["--dataset", dataset, "--root", "/data"] + flags
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + argv)
    jargs = jscript.parse_args()
    targs = tevaluate.parse_args(argv)
    assert vars(targs) == vars(jargs)
    name = "ModelNet40" if dataset == "Synthetic" else dataset
    t = tevaluate.apply_overrides(tconfig.make_cfg(name, "/data"), targs)
    j = jscript.apply_overrides(jax_make_cfg(name, "/data"), jargs)
    _same_config(t, j)


def _test_layout(root, rs, pairs=((0, 1), (0, 2))):
    """One 3DMatch test scene: fragments of an indoor-like scene seen from
    small offsets, its gt.log over ``pairs`` (the protocol scores the pairs
    more than one fragment apart) and a gt.info."""
    frags = 1 + max(j for _i, j in pairs)
    scene = splits.THREEDMATCH_TEST_SCENES[0]
    base = os.path.join(root, "test", "3DMatch")
    n = 6000
    world = np.concatenate([
        np.c_[rs.uniform(0, 3, (n // 2, 2)), rs.normal(0, 0.005, n // 2)],
        np.c_[rs.uniform(0, 3, n // 4), rs.normal(0, 0.005, n // 4),
              rs.uniform(0, 2, n // 4)],
        rs.uniform(0.5, 1.5, (n - n // 2 - n // 4, 3)),
    ]).astype(np.float32)
    poses = []
    for i in range(frags):
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.05 * i, 0.0]
        poses.append(T)
        tio.save_ply(os.path.join(base, "fragments", scene,
                                  f"cloud_bin_{i}.ply"),
                     world[rs.rand(n) < 0.85] - T[:3, 3])
    pairs = [[i, j, frags] for i, j in pairs]
    gt = [np.linalg.inv(poses[j]) @ poses[i] for i, j, _ in pairs]
    gt_dir = os.path.join(base, "gt_result", scene)
    tbase.write_trajectory_log(os.path.join(gt_dir, "gt.log"), pairs,
                               [np.linalg.inv(T) for T in gt])
    with open(os.path.join(gt_dir, "gt.info"), "w") as f:
        for i, j, m in pairs:
            f.write(f"{i}\t{j}\t{m}\n")
            for r in range(6):
                f.write("\t".join(str(100.0 * (r == c)) for c in range(6))
                        + "\n")
    return scene


def test_evaluate_cli_on_a_3dmatch_layout(tmp_path):
    rs = np.random.RandomState(0)
    scene = _test_layout(str(tmp_path / "data"), rs)
    out = str(tmp_path / "out")
    lines = []
    summary = tevaluate.run(
        ["--dataset", "3DMatch", "--root", str(tmp_path / "data"), "--cpu",
         "--fast", "--num-scales", "1", "--num-fps", "128",
         "--checkpoint-dir", SNAP, "--out-dir", out, "--experiment-id", "t"],
        log=lines.append)
    assert summary["num_pairs"] == 2 and len(summary["rows"]) == 2
    with open(os.path.join(out, "t", "3DMatch_per_sample.csv")) as f:
        header = next(csv.reader(f))
    assert header == jax_result_io.PER_SAMPLE_COLUMNS
    assert os.path.exists(os.path.join(out, "t", "summary.csv"))
    assert len(os.listdir(os.path.join(out, "t", "full_results"))) == 1
    assert os.path.exists(os.path.join(out, "t", "logs", f"{scene}.log"))
    assert 0.0 <= summary["rmse_recall"] <= 1.0
    assert any("[rmse protocol]" in line for line in lines)
    assert any("snapshot config" in line for line in lines)


def test_rmse_protocol_equals_the_jax_function(tmp_path):
    """From the same rows, the same ``.log`` files (byte for byte) and the
    same recall, with one estimate off by 0.5 m."""
    rs = np.random.RandomState(1)
    root = str(tmp_path / "data")
    scene = _test_layout(root, rs, pairs=((0, 1), (0, 2), (1, 3), (0, 3)))
    gt_pairs, gts = tbase.read_trajectory_log(os.path.join(
        root, "test", "3DMatch", "gt_result", scene, "gt.log"))
    rows = []
    for (i, j, _n), T in zip(gt_pairs, gts):
        pose = np.linalg.inv(T)
        if i == 1:
            pose = pose.copy()
            pose[0, 3] += 0.5
        rows.append(dict(src_id=f"x/fragments/{scene}/cloud_bin_{i}.ply",
                         tgt_id=f"x/fragments/{scene}/cloud_bin_{j}.ply",
                         pose=pose))
    jcfg = jax_make_cfg("3DMatch", root)
    tcfg = tconfig.make_cfg("3DMatch", root)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jrec = _jax_script("evaluate").rmse_protocol(jcfg, None, rows, jdir)
    trec = tevaluate.rmse_protocol(tcfg, rows, tdir, log=lambda *_: None)
    assert trec == jrec == 2.0 / 3.0
    for name in os.listdir(os.path.join(jdir, "logs")):
        with open(os.path.join(jdir, "logs", name), "rb") as a, \
                open(os.path.join(tdir, "logs", name), "rb") as b:
            assert a.read() == b.read()


TINY = dict(
    patch=dict(desc_mode="moments", desc_pool="gated", num_fps=48,
               num_points_radius_estimate=64, num_points_per_patch=32,
               num_scales=1, search_radius_thresholds=(2.0,)),
    capacity=dict(max_points=1024, num_ransac_hypotheses=64,
                  ransac_chunk=64),
)


def test_harness_log_profile_and_progress(tmp_path, capsys):
    cfg = tconfig.make_cfg("ModelNet40").override(**TINY)
    from bufferx_tpu_torch.tools.weights import load_snapshot

    pairs = list(tevaluate.synthetic_pairs(10, seed=3, num_points=1000))
    logged = []
    summary = harness.evaluate_pairs(
        cfg, pairs, load_snapshot(SNAP), log=logged.append,
        profile_dir=str(tmp_path / "prof"), progress=True, device="cpu")
    assert summary["num_pairs"] == 10
    assert len(logged) == 1 and logged[0].startswith("[10] recall")
    traces = os.listdir(tmp_path / "prof")
    assert traces == [f"pair{harness.WARMUP}.trace.json"]
    with open(tmp_path / "prof" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    err = capsys.readouterr()
    assert "ModelNet40" in err.out + err.err


def _train_layout(root, rs):
    """A 3DMatch train/val manifest whose fragments are one scene seen
    from each fragment's pose (so the pairs have ground-truth matches)."""
    import pickle

    train = os.path.join(root, "train")
    overlap = {}
    for scene in ("scene-a", "scene-b"):
        world = np.concatenate([
            np.c_[rs.uniform(0, 2, (1500, 2)), rs.normal(0, 0.003, 1500)],
            rs.uniform(0.4, 1.2, (700, 3)),
        ]).astype(np.float32)
        for i in range(3):
            T = np.eye(4)
            T[:3, 3] = [0.05 * i, -0.03 * i, 0.0]
            fid = f"{scene}/seq-01/cloud_bin_{i}"
            tio.save_ply(os.path.join(train, fid + ".ply"),
                         world[rs.rand(len(world)) < 0.9] - T[:3, 3])
            np.save(os.path.join(train, fid + ".pose.npy"), T)
        overlap[f"{scene}/seq-01/cloud_bin_0@{scene}/seq-01/cloud_bin_1"] = 0.8
        overlap[f"{scene}/seq-01/cloud_bin_1@{scene}/seq-01/cloud_bin_2"] = 0.8
    with open(os.path.join(train, "3DMatch_train_overlap.pkl"), "wb") as f:
        pickle.dump(overlap, f)
    for split, scene in (("train", "scene-a"), ("val", "scene-b")):
        with open(os.path.join(train, f"{split}_3dmatch.txt"), "w") as f:
            f.write(scene + "\n")


SMALL_TRAIN = dict(
    patch=dict(desc_mode="moments", num_points_per_patch=32),
    capacity=dict(max_points=1024, sphere_query_chunk=64),
    train=dict(pos_num=24),
)


def test_train_cli_on_a_3dmatch_layout(tmp_path, monkeypatch):
    _train_layout(str(tmp_path / "data"), np.random.RandomState(2))
    real = tconfig.make_cfg
    monkeypatch.setattr(tconfig, "make_cfg",
                        lambda *a, **k: real(*a, **k).override(**SMALL_TRAIN))
    monkeypatch.chdir(tmp_path)
    lines = []
    assert ttrain.main(["--dataset", "3DMatch", "--root",
                        str(tmp_path / "data"), "--cpu", "--epochs", "1",
                        "--steps-per-epoch", "2", "--experiment-id", "e"],
                       log=lines.append) == 0
    snap = tmp_path / "snapshot" / "3DMatch" / "e"
    jcfg = jax_make_cfg("3DMatch").override(**SMALL_TRAIN)
    # the JAX package's parameter tree, shapes only (no initialization)
    template = jax.eval_shape(
        lambda: jax_init_params(jcfg, jax.random.PRNGKey(0)))
    for stage, key in (("Desc", "desc"), ("Pose", "pose")):
        path = snap / stage / "best.msgpack"
        assert path.exists(), stage
        got = jax_load_params(str(path), template[key])
        leaves, want = jax.tree.leaves(got), jax.tree.leaves(template[key])
        assert len(leaves) == len(want) > 0
        assert all(np.shape(x) == w.shape and np.all(np.isfinite(x))
                   for x, w in zip(leaves, want))
        with open(snap / stage / "scalars.jsonl") as f:
            assert len(f.readlines()) == 1
    assert any("epoch 1 done" in line for line in lines)
    # the stream: a permutation of the split and one batch a sample
    from bufferx_tpu_torch.data.datasets import get_dataset

    cfg = tconfig.make_cfg("3DMatch", str(tmp_path / "data"))
    stream = ttrain.dataset_stream(cfg, get_dataset(cfg, "train"), 2,
                                   np.random.RandomState(0),
                                   torch.device("cpu"))
    batches = list(stream())
    assert len(batches) == 2
    assert batches[0]["src_kpt"].shape == (24, 3)
    assert bool(batches[0]["corr_valid"].any())
