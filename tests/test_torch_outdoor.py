"""The outdoor preset, ``make_cfg("KITTI")`` with the sampled descriptor and
the fused conv stack, served through ``register_pairs_batched`` at a tiny
size on the CPU (128 keypoints, 160 probes, 64-point patches, 2048
points), on two pairs of the benchmark's LiDAR street scans
(``benchmark/generators/lidar_street.py``, 32 beams, 15 m of range, the
scans 4 m apart).

The preset's flag sends every patch through the gravity-aligned branch
(``align_patches`` keeps the global frame), with ``dist_th`` 0.3,
``similar_th`` 0.9 and ``inlier_th`` 2.0, no prefilter and no IRLS.

- Against the benchmark's plain reference (``benchmark/reference/``, which
  imports nothing of the port), with seeded random weights
  (``init_params``) and 300 RANSAC hypotheses scored in chunks of 128 (a
  ragged last chunk of 44): every result equal, with every pair redone
  and with the early exit at one inlier.
- Against the JAX package with the same draws and ``snapshot/hard`` (256
  hypotheses: the JAX solver's budget must be a multiple of its chunk):
  every scale's candidates (the same keypoints and mutual matches,
  rotations about z alone, yaws within a fraction of a bin), the solve on the
  same candidates (the same inliers, poses within 0.02 m and 0.5
  degrees), and ``register_pairs_batched`` end to end (the same scales,
  mutual matches within 10%).
- ``bufferx.ransac`` nests in ``bufferx.solve`` with the pass's pairs; the
  host counter ``ransac.hypotheses`` reads B x H a solve while tracing is
  on, nothing while it is off, and nothing on the GNC branch.
"""

import dataclasses
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.generators import lidar_street
from benchmark.reference import registration as ref
from bufferx_tpu.config import make_cfg as jax_make_cfg
from bufferx_tpu.pipeline import registration as jreg
from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.pipeline import registration as treg
from bufferx_tpu_torch.solver.ransac import HYPOTHESES
from bufferx_tpu_torch.tools.weights import load_snapshot
from bufferx_tpu_torch.utils.timers import count, counters, spans, tracing
from test_torch_batched import _batch_draws
from test_torch_pipeline import (  # noqa: F401
    SNAP_SAMPLED,
    _jax_draws,
    few_threads,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    patch=dict(fused_conv=True, num_fps=128, num_points_radius_estimate=160,
               num_points_per_patch=64),
    capacity=dict(max_points=2048, num_ransac_hypotheses=300,
                  ransac_chunk=128),
)
SCANS = dict(scenes=1, pairs_per_scene=2, beams=32, azimuth_steps=512,
             max_range=15.0, spacing=2.0, separation=[4.0, 4.0],
             dropout=0.02, max_num_pts=4000, block=2)
SEED = 2 ** 33 + 3
N_PAIRS = BATCH = 2
# early-exit thresholds: every pair redone, or the scale-0 solve kept from
# one inlier on
MODES = {"redo": 10 ** 6, "exit": 1}


def _cfg(hypotheses=300, mode="redo"):
    over = dict(TINY, capacity=dict(TINY["capacity"],
                                    num_ransac_hypotheses=hypotheses),
                match=dict(early_exit_min_inliers=MODES[mode]))
    return make_cfg("KITTI").override(**over)


@pytest.fixture(scope="module")
def world():
    """The two pairs as both packages take them, and seeded random
    weights."""
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "lidar_b8.json")) as f:
        params = dict(json.load(f)["params"], **SCANS)
    pool = lidar_street.pairs(SEED, params)
    cfg = _cfg()
    weights = treg.init_params(cfg, torch.Generator().manual_seed(0))
    return dict(
        pool=pool, weights=weights,
        models=treg.build_models(treg.PipelineStatics.from_config(cfg),
                                 weights, "cpu"),
        srcs=[treg.prepare_cloud(p[0], cfg, seed=2 * i, device="cpu")
              for i, p in enumerate(pool)],
        tgts=[treg.prepare_cloud(p[1], cfg, seed=2 * i + 1, device="cpu")
              for i, p in enumerate(pool)])


def _serve(w, cfg, models, draws):
    return treg.register_pairs_batched(cfg, w["srcs"], w["tgts"], models,
                                       batch_size=BATCH, draws=draws,
                                       device="cpu")


def _draws(cfg, seed=1):
    statics = treg.PipelineStatics.from_config(cfg)
    gen = torch.Generator().manual_seed(seed)
    return [tuple(treg.make_draws(statics, gen, "cpu", batch=BATCH)
                  for _phase in range(2))]


def test_the_preset_as_the_port_runs_it():
    """The KITTI preset with the benchmark's overrides: the JAX package's
    statics, the outdoor solver settings and the aligned flag."""
    over = dict(patch=dict(fused_conv=True),
                capacity=dict(num_ransac_hypotheses=50000))
    tcfg = make_cfg("KITTI").override(**over)
    ts = treg.PipelineStatics.from_config(tcfg)
    js = jreg.PipelineStatics.from_config(jax_make_cfg("KITTI").override(
        **over))
    for name in ts.__dataclass_fields__:
        assert getattr(ts, name) == getattr(js, name), name
    assert tcfg.patch.is_aligned_to_global_z
    assert (ts.dist_th, ts.similar_th, ts.inlier_th) == (0.3, 0.9, 2.0)
    assert not ts.clutter_filter and not ts.pose_refine
    assert (ts.num_hypotheses, ts.ransac_chunk) == (50000, 2048)
    assert (tcfg.match.iter_n, tcfg.match.confidence) == (50000, 1.0)


@pytest.mark.parametrize("mode", list(MODES))
def test_aligned_batch_equals_the_reference(world, mode, monkeypatch):
    """Random weights, a ragged last RANSAC chunk: the port's two-phase
    serving equals the plain reference's, pair by pair, and every patch
    took the aligned branch (the flag from the configuration)."""
    cfg = _cfg(mode=mode)
    flags = []
    inner = treg.align_patches

    def align(delta, kpts, is_aligned):
        flags.append(is_aligned)
        return inner(delta, kpts, is_aligned)

    monkeypatch.setattr(treg, "align_patches", align)
    draws = _draws(cfg)
    got = _serve(world, cfg, world["models"], draws)
    assert flags and all(f is True for f in flags)
    statics = json.loads(json.dumps(dict(
        dataclasses.asdict(treg.PipelineStatics.from_config(cfg)),
        is_aligned=True)))
    s = ref.Statics.from_dict(statics)
    cpu = torch.device("cpu")
    pool = world["pool"]
    want = ref.register_batches(
        ref.build_models(s, world["weights"], cpu), s,
        [ref.prepare_cloud(p[0], s.max_points, 2 * i, cpu)
         for i, p in enumerate(pool)],
        [ref.prepare_cloud(p[1], s.max_points, 2 * i + 1, cpu)
         for i, p in enumerate(pool)], [list(range(N_PAIRS))],
        [tuple(ref.Draws(*d) for d in draws[0])])
    assert [int(r.scales_used) for r in got] == [
        int(r.scales_used) for r in want]
    for a, b in zip(got, want):
        for name in treg.RegistrationResult._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.fixture(scope="module")
def jax_world(world):
    """``snapshot/hard`` on both sides, 256 hypotheses (the JAX solver's
    budget must be a multiple of its chunk), the pairs as JAX takes them,
    a key a pair and the port's draws from those keys."""
    over = dict(TINY, capacity=dict(TINY["capacity"],
                                    num_ransac_hypotheses=256),
                match=dict(early_exit_min_inliers=MODES["redo"]))
    jcfg = jax_make_cfg("KITTI").override(**over)
    params = {}
    for stage in ("Desc", "Pose"):
        with open(os.path.join(SNAP_SAMPLED, stage, "best.msgpack"),
                  "rb") as f:
            params[stage.lower()] = jax.tree.map(
                jnp.asarray, flax.serialization.msgpack_restore(f.read()))
    cfg = _cfg(256)
    statics = treg.PipelineStatics.from_config(cfg)
    jst = jreg.PipelineStatics.from_config(jcfg)
    pool = world["pool"]
    keys = jax.random.split(jax.random.PRNGKey(0), N_PAIRS)
    return dict(
        jcfg=jcfg, params=params, cfg=cfg, statics=statics, jst=jst,
        keys=keys,
        models=treg.build_models(statics, load_snapshot(SNAP_SAMPLED), "cpu"),
        jsrcs=[jreg.prepare_cloud(p[0], jcfg, seed=2 * i)
               for i, p in enumerate(pool)],
        jtgts=[jreg.prepare_cloud(p[1], jcfg, seed=2 * i + 1)
               for i, p in enumerate(pool)],
        draws=treg.stack_draws([_jax_draws(k, jst, 3)[1] for k in keys]))


def _jax_candidates(jw):
    """Every scale's candidates of the batch, and the solve's keys, as the
    JAX package's split serving path makes them."""
    return jreg._batch_candidates_jit(
        jw["params"], jw["jst"], jreg.stack_clouds(jw["jsrcs"]),
        jreg.stack_clouds(jw["jtgts"]), jnp.ones(N_PAIRS, bool),
        jw["keys"], (0, 1, 2))


def test_aligned_candidates_match_jax(world, jax_world):
    """Every scale's candidates of the aligned branch, with the JAX
    package's draws: the same keypoints, the same mutual matches on at
    least 95% of them, candidate rotations about z alone on both sides
    (the patches keep the global frame), and the yaws of the matches both
    sides share within half a degree at the median and a tenth of the
    head's 18-degree bin at the 90th percentile."""
    jw = jax_world
    jc, _k0 = _jax_candidates(jw)
    tc = treg._cat_candidates(treg._batch_candidates(
        jw["models"], jw["statics"], treg.stack_clouds(world["srcs"]),
        treg.stack_clouds(world["tgts"]), jw["draws"], (0, 1, 2), True))
    j = {name: np.asarray(getattr(jc, name)) for name in jc._fields}
    t = {name: getattr(tc, name).numpy() for name in tc._fields}
    np.testing.assert_allclose(t["ss"], j["ss"], rtol=0, atol=1e-5)
    assert (t["valid"] == j["valid"]).mean() >= 0.95
    for side in (t, j):
        r = side["Rc"][side["valid"]]
        np.testing.assert_allclose(r[:, 2, 2], 1.0, atol=1e-5)
        np.testing.assert_allclose(r[:, :2, 2], 0.0, atol=1e-5)
        np.testing.assert_allclose(r[:, 2, :2], 0.0, atol=1e-5)
    both = t["valid"] & j["valid"] & np.all(
        np.abs(t["tt"] - j["tt"]) < 1e-5, axis=-1)
    assert both.sum() >= 0.9 * j["valid"].sum()
    # the head's yaw is continuous (a soft argmax over 20 bins of 18
    # degrees) and its bf16 inputs round apart, so shared matches agree in
    # yaw to a fraction of a bin, not to the bit
    yaw = [np.degrees(np.arctan2(side["Rc"][..., 1, 0],
                                 side["Rc"][..., 0, 0]))[both]
           for side in (t, j)]
    gap = np.abs((yaw[0] - yaw[1] + 180.0) % 360.0 - 180.0)
    assert np.median(gap) <= 0.5 and np.quantile(gap, 0.9) <= 1.8, \
        np.quantile(gap, [0.5, 0.9])


def test_aligned_solve_matches_jax(jax_world):
    """The JAX package's candidates through both solvers (consensus at
    ``inlier_th`` 2.0, the sampling pool, RANSAC at ``dist_th`` 0.3 and
    ``similar_th`` 0.9 with the same rank draws, the refit): the same
    inliers and poses within 0.02 m and 0.5 degrees."""
    jw = jax_world
    jc, k0 = _jax_candidates(jw)
    jsrc, jtgt = (jreg.stack_clouds(jw["jsrcs"]),
                  jreg.stack_clouds(jw["jtgts"]))
    jres = jreg._batch_solve_jit(jw["jst"], jc, k0, jsrc, jtgt, 3)
    cand = treg._Candidates(*(torch.from_numpy(np.array(x)) for x in jc))
    src = treg.Cloud(torch.from_numpy(np.array(jsrc.xyz)),
                     torch.from_numpy(np.array(jsrc.mask)))
    tgt = treg.Cloud(torch.from_numpy(np.array(jtgt.xyz)),
                     torch.from_numpy(np.array(jtgt.mask)))
    tres = treg._pool_and_solve(jw["statics"], cand, jw["draws"].ransac,
                                src, tgt, 3)
    for b in range(N_PAIRS):
        jpose = torch.from_numpy(np.array(jres.pose[b]))
        assert float(se3.compute_rte(tres.pose[b], jpose)) <= 0.02
        assert float(se3.compute_rre(tres.pose[b], jpose)) <= 0.5
        assert int(tres.num_inliers[b]) == int(jres.num_inliers[b])
        assert int(tres.num_consensus[b]) == int(jres.num_consensus[b])


def test_aligned_batch_serves_as_jax(world, jax_world):
    """``register_pairs_batched`` on both sides with the JAX package's own
    draws (a batch's keys as its ``register_pairs_batched`` splits them),
    every pair redone: the same scales and validity, finite poses, and
    mutual matches within 10%. (With a handful of inliers a tiny pair's
    RANSAC winner follows any one differing match, so the poses are held
    by the two tests above.)"""
    jw = jax_world
    key = jax.random.PRNGKey(0)
    jres = jreg.register_pairs_batched(
        jw["jcfg"], jw["jsrcs"], jw["jtgts"], key, jw["params"], True,
        batch_size=BATCH)
    tres = _serve(world, jw["cfg"], jw["models"], _batch_draws(
        key, jw["jst"], N_PAIRS, BATCH))
    assert len(jres) == len(tres) == N_PAIRS
    for j, t in zip(jres, tres):
        assert int(t.scales_used) == int(j.scales_used) == 3
        assert bool(torch.isfinite(t.pose).all())
        n_mutual = int(j.num_mutual)
        assert abs(int(t.num_mutual) - n_mutual) <= 0.1 * n_mutual
        assert bool(t.valid) == bool(j.valid)


def test_ransac_span_and_hypotheses(world):
    """Under ``tracing()``: a ``bufferx.ransac`` under each ``bufferx.solve``
    with its pairs, and the counter at B x H a solve (phase 1's batch and
    the redo batch); off, the counter stays at nothing."""
    cfg = _cfg(mode="redo")
    draws = _draws(cfg)
    spans()
    _serve(world, cfg, world["models"], draws)
    assert spans() == [] and counters() == {}
    with tracing():
        _serve(world, cfg, world["models"], draws)
    records = spans()
    by_id = {r.id: r for r in records}
    solves = [r for r in records if r.name == "bufferx.solve"]
    ransacs = [r for r in records if r.name == "bufferx.ransac"]
    assert len(solves) == len(ransacs) == 2
    for r in ransacs:
        parent = by_id[r.parent]
        assert parent.name == "bufferx.solve" and r.pairs == parent.pairs
        assert r.stream_ms is not None
    assert counters() == {HYPOTHESES: 300 * (N_PAIRS + N_PAIRS)}
    assert spans() == [] and counters() == {}


def test_the_gnc_branch_scores_no_hypotheses(world):
    cfg = _cfg().override(match=dict(pose_estimator="gnc"))
    spans()
    with tracing():
        _serve(world, cfg, world["models"], _draws(cfg))
    names = {r.name for r in spans()}
    assert "bufferx.solve" in names and "bufferx.ransac" not in names
    assert counters().get(HYPOTHESES, 0) == 0


def test_counters_are_read_with_the_spans():
    spans()
    count("test.counter", 5)                 # tracing off: not counted
    with tracing():
        count("test.counter", 2)
        count("test.counter", 3)
        assert counters() == {}              # not read yet
    assert spans() == [] and counters() == {"test.counter": 5}
    assert counters() == {"test.counter": 5}     # a read, not a reset
    spans()
    assert counters() == {}
