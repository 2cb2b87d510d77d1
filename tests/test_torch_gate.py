"""The hard-gate runner (``bufferx_tpu_torch/tools/exp_hard.py``) against
``scripts/exp_hard.py``: the same cells in the same order, the same
configuration (statics field by field), the same ``--set`` parsing and
Wilson interval; and one cell of the ``--quick`` grid (overlap 0.75, no
noise; the 3DMatch configuration runs the clutter prefilter on every cell)
scored by both, 2 pairs in one batch of 2 at the ``--quick`` capacities,
the port fed the JAX runner's own draws: the same pairs succeed, also with
``--no-strat`` (the block query, its draws per scale) and with
``--exact-topk`` (the fused query; the flag changes no query of the port);
``--no-clutter-filter`` turns the prefilter off.

Why not the clutter cell: at the ``--quick`` capacities its pairs end with
3-15 solver inliers, and one prefilter flip (pinned in
``test_torch_density.py``) moves the keypoints enough to decide such a pair
either way (measured: pair 0 of quick cell 6 registers on the port with 12
inliers and fails in JAX with 3). The clutter cells are compared on the
card, statistically, at full width and n = 200; on the CPU,
``test_torch_pipeline.py`` holds ``register_pair`` with the prefilter on
cluttered pairs that register robustly.
"""

import importlib.util
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.config import make_cfg as jax_make_cfg
from bufferx_tpu.core import se3 as jse3
from bufferx_tpu.data.hardsynth import hard_pair as jax_hard_pair
from bufferx_tpu.pipeline import registration as jreg
from bufferx_tpu.train.trainer import load_snapshot_config as jax_snap_config
from bufferx_tpu_torch.pipeline import registration as treg
from bufferx_tpu_torch.tools import exp_hard
from bufferx_tpu_torch.tools.weights import load_snapshot
from test_torch_pipeline import SNAP, _jax_draws, few_threads  # noqa: F401
from test_torch_queries import jax_scale_draws

ROOT = os.path.join(os.path.dirname(__file__), "..")
SEED, CELL, N_PAIRS = 20240, 2, 2


def _jax_runner():
    """``scripts/exp_hard.py`` as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        "jax_exp_hard", os.path.join(ROOT, "scripts", "exp_hard.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_config(quick, exact_topk=False, no_strat=False):
    """The configuration ``scripts/exp_hard.py`` builds with its defaults,
    ``--checkpoint-dir SNAP`` and the two query flags."""
    cfg = jax_make_cfg("3DMatch").override(
        data=dict(root=""),
        patch=dict(desc_mode="moments", exact_topk=exact_topk,
                   block_ball_query=not exact_topk,
                   strat_ball_query=not no_strat),
        test=dict(pose_refine=True),
    )
    cfg = cfg.override(patch=jax_snap_config(SNAP))
    if quick:
        cfg = cfg.override(
            capacity=dict(max_points=4096, num_ransac_hypotheses=1024,
                          ransac_chunk=256, sphere_query_chunk=64),
            patch=dict(num_fps=384, num_points_radius_estimate=384,
                       num_points_per_patch=256),
        )
    return cfg


@pytest.mark.parametrize("quick", [False, True])
def test_cells_and_config_match_the_jax_runner(quick):
    assert exp_hard.build_cells(quick) == _jax_runner().build_cells(quick)
    assert len(exp_hard.build_cells(quick)) == (7 if quick else 17)
    ts = treg.PipelineStatics.from_config(
        exp_hard.gate_config("moments", SNAP, quick=quick))
    js = jreg.PipelineStatics.from_config(_jax_config(quick))
    for name in ts.__dataclass_fields__:
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.clutter_filter and ts.pose_refine and not ts.exact_topk


def test_set_parsing_and_wilson():
    assert exp_hard.parse_set([
        "match.pose_estimator=gnc", "patch.mxu_gather=True",
        "capacity.num_ransac_hypotheses=16384", "match.inlier_th=1.5",
    ]) == [("match", "pose_estimator", "gnc"), ("patch", "mxu_gather", True),
           ("capacity", "num_ransac_hypotheses", 16384),
           ("match", "inlier_th", 1.5)]
    cfg = exp_hard.gate_config("moments", SNAP,
                               ["match.pose_estimator=gnc"])
    assert cfg.match.pose_estimator == "gnc"
    # the reference rows carry the interval of their own recall
    with open(os.path.join(ROOT, "GATE_r05_final_n200.jsonl")) as f:
        rows = [json.loads(line) for line in f if '"recall"' in line]
    assert len(rows) == 17
    for row in rows:
        lo, hi = exp_hard.wilson(row["recall"], row["n"])
        assert (round(lo, 4), round(hi, 4)) == (row["wilson_lo"],
                                                 row["wilson_hi"])


@pytest.mark.parametrize("flag", ["--exact-topk", "--no-strat"])
def test_unported_patch_queries_raise(flag):
    """The two query flags run: their configuration is the JAX runner's,
    the CLI accepts them, and the ``--quick`` cell scores as the JAX runner
    scores it with its draws (``--no-strat``: the block query per scale;
    ``--exact-topk``: the fused query)."""
    kw = {"--exact-topk": dict(exact_topk=True),
          "--no-strat": dict(no_strat=True)}[flag]
    tcfg = exp_hard.gate_config("moments", SNAP, quick=True, **kw)
    ts = treg.PipelineStatics.from_config(tcfg)
    js = jreg.PipelineStatics.from_config(_jax_config(True, **kw))
    for name in ts.__dataclass_fields__:
        assert getattr(ts, name) == getattr(js, name), name
    treg._check_ported(ts)
    assert treg.fused_query(ts) == (flag == "--exact-topk")
    _check_quick_cell(**kw)


def test_no_clutter_filter_and_no_block_ball_query():
    cfg = exp_hard.gate_config("moments", SNAP, no_clutter_filter=True,
                               no_block_ball_query=True)
    st = treg.PipelineStatics.from_config(cfg)
    treg._check_ported(st)          # both run, as in the JAX runner
    assert not st.clutter_filter and st.strat_ball_query


def test_quick_cell_matches_the_jax_runner():
    _check_quick_cell()


def _check_quick_cell(exact_topk=False, no_strat=False):
    cell = exp_hard.build_cells(True)[CELL]
    assert (cell["overlap"], cell["noise_vox"], cell["clutter"]) == (0.75, 0.0, 0.0)
    jcfg = _jax_config(True, exact_topk, no_strat)
    tcfg = exp_hard.gate_config("moments", SNAP, quick=True,
                                exact_topk=exact_topk, no_strat=no_strat)
    jst = jreg.PipelineStatics.from_config(jcfg)
    params = {}
    for stage in ("Desc", "Pose"):
        with open(os.path.join(SNAP, stage, "best.msgpack"), "rb") as f:
            params[stage.lower()] = jax.tree.map(
                jnp.asarray, flax.serialization.msgpack_restore(f.read()))
    # the JAX runner's loop for one cell and one batch (scripts/exp_hard.py
    # :197-230), keys as it splits them
    key = jax.random.PRNGKey(SEED + CELL)
    key, sub = jax.random.split(key)
    keys = jax.random.split(sub, N_PAIRS)
    srcs, tgts, gts = [], [], []
    for i in range(N_PAIRS):
        rs = np.random.RandomState(SEED * 1000 + CELL * 101 + i)
        s, t, T = jax_hard_pair(
            rs, family="eval", num_points=4096, overlap_ratio=cell["overlap"],
            noise=cell["noise_vox"] * 0.025, density_ratio=cell["density"],
            outlier_frac=cell["clutter"])
        srcs.append(jreg.prepare_cloud(s, jcfg, seed=i))
        tgts.append(jreg.prepare_cloud(t, jcfg, seed=i + 1))
        gts.append(T)
    batched = jax.jit(jax.vmap(
        lambda s, t, a, k: jreg.register_pair_jit(params, jst, s, t, a, k)))
    res = batched(jreg.stack_clouds(srcs), jreg.stack_clouds(tgts),
                  jnp.zeros((N_PAIRS,), bool), keys)
    gt_b = jnp.asarray(np.stack(gts))
    rte = np.asarray(jse3.compute_rte(res.pose, gt_b))
    rre = np.asarray(jse3.compute_rre(res.pose, gt_b))
    jax_success = ((rte < 0.3) & (rre < 15.0)).tolist()

    models = treg.build_models(treg.PipelineStatics.from_config(tcfg),
                               load_snapshot(SNAP), "cpu")
    if treg.fused_query(treg.PipelineStatics.from_config(tcfg)):
        one = [_jax_draws(k, jst)[1] for k in keys]
    else:
        one = [jax_scale_draws(k, jst, "blocks") for k in keys]
    draws = [treg.stack_draws(one)]
    row = exp_hard.run_cell(tcfg, models, cell, CELL,
                            pairs_per_cell=N_PAIRS, num_points=4096,
                            batch=N_PAIRS, voxel=0.025, seed=SEED,
                            device="cpu", draws=draws)
    assert row["successes"] == jax_success
    assert any(jax_success)
    assert row["n"] == N_PAIRS and row["device"] == "cpu"
    assert row["recall"] == round(float(np.mean(jax_success)), 4)
    for k in ("overlap", "noise_vox", "density", "clutter", "mode",
              "exact_topk", "wilson_lo", "wilson_hi", "rte_med", "rre_med",
              "rte_med_succ", "pairs_per_s", "device_name"):
        assert k in row
    assert torch.get_num_threads() <= 2     # few_threads holds
