"""Port parity, end to end: ``_precompute`` and ``register_pair`` against the
JAX package on seeded synthetic pairs at a small size (2048 points, 128
keypoints, 160 probes, 64-point patches, 256 hypotheses), with the
``hard_moments_r4ft2`` weights in bf16 and JAX's own random draws (strip
offsets and RANSAC ranks) fed to the port; and the reference "sampled"
descriptor with the fused conv stack and the ``snapshot/hard`` weights.

Tolerances: keypoints and radii exact (FPS is exact; radii are rounded to
1 cm); d2 to 1e-4 (the JAX side is bf16 hi/lo-compensated, error
<= 2^-16 |a||b|); at most 1% of patch slots may change validity, and
slots valid on both sides agree to 1e-6 (they decode the same quantized
coordinates). Final poses agree to 0.02 m and 2 degrees (bf16 descriptors
and boundary flips move a few matches; measured <= 5.6 mm and 0.66 deg),
and success against ModelNet40's thresholds agrees pair by pair; the
sampled + fused path is held to the same bounds.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.config import make_cfg as jax_make_cfg
from bufferx_tpu.data.modelnet import synthetic_pair_full_overlap as jax_pair
from bufferx_tpu.pipeline import registration as jreg
from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu_torch.pipeline import registration as treg
from bufferx_tpu_torch.tools.weights import load_snapshot, load_snapshot_config

SNAP = os.path.join(os.path.dirname(__file__), "..", "snapshot",
                    "hard_moments_r4ft2")
SNAP_SAMPLED = os.path.join(os.path.dirname(__file__), "..", "snapshot",
                            "hard")
SMALL = dict(
    patch=dict(desc_mode="moments", desc_pool="gated", num_fps=128,
               num_points_radius_estimate=160, num_points_per_patch=64),
    capacity=dict(max_points=2048, num_ransac_hypotheses=256,
                  ransac_chunk=128),
)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs several workers on few cores: two intra-op threads a
    process keep PyTorch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_make_cfg("ModelNet40").override(**SMALL)
    tcfg = make_cfg("ModelNet40").override(**SMALL)
    params = {}
    for stage in ("Desc", "Pose"):
        with open(os.path.join(SNAP, stage, "best.msgpack"), "rb") as f:
            params[stage.lower()] = jax.tree.map(
                jnp.asarray, flax.serialization.msgpack_restore(f.read()))
    tstat = treg.PipelineStatics.from_config(tcfg)
    models = treg.build_models(tstat, load_snapshot(SNAP), "cpu")
    return jcfg, tcfg, params, models


@pytest.fixture(scope="module")
def sampled_setup():
    """The sampled + fused configuration: ``snapshot/hard`` has no
    config.json, so the default ``desc_mode="sampled"`` stands."""
    small = dict(SMALL, patch=dict(SMALL["patch"], desc_mode="sampled",
                                   fused_conv=True))
    jcfg = jax_make_cfg("ModelNet40").override(**small)
    tcfg = make_cfg("ModelNet40").override(**small)
    params = {stage.lower(): jax.tree.map(jnp.asarray,
                                          flax.serialization.msgpack_restore(
                                              open(os.path.join(
                                                  SNAP_SAMPLED, stage,
                                                  "best.msgpack"), "rb").read()))
              for stage in ("Desc", "Pose")}
    tstat = treg.PipelineStatics.from_config(tcfg)
    models = treg.build_models(tstat, load_snapshot(SNAP_SAMPLED), "cpu")
    assert models.desc.fused and tstat.desc_mode == "sampled"
    return jcfg, tcfg, params, models


def _pair(i, jcfg, tcfg):
    s, t, T = synthetic_pair_full_overlap(np.random.RandomState(i), 2000)
    js, jt, jT = jax_pair(np.random.RandomState(i), 2000)
    np.testing.assert_array_equal(s, js)       # the port's own data copy
    np.testing.assert_array_equal(T, jT)
    return (jreg.prepare_cloud(s, jcfg, seed=i),
            jreg.prepare_cloud(t, jcfg, seed=i),
            treg.prepare_cloud(s, tcfg, seed=i, device="cpu"),
            treg.prepare_cloud(t, tcfg, seed=i, device="cpu"), T)


def _jax_draws(key, statics, num_scales=3):
    """The draws ``register_pair_jit`` makes from ``key``."""
    keys = jax.random.split(key, 4 + 2 * num_scales)
    ks, kt = jax.random.split(keys[1])
    nf, s = statics.num_fps, statics.patch_sample
    l = statics.max_points // s

    def offsets(k):
        return torch.from_numpy(np.array(
            jax.random.randint(k, (nf, s), 0, l, dtype=jnp.int32)))

    ranks = np.array(jax.random.randint(
        keys[0], (statics.num_hypotheses, 3), 0, jnp.int32(1 << 30),
        dtype=jnp.int32))
    return keys, treg.Draws(offsets(ks), offsets(kt), torch.from_numpy(ranks))


def test_statics_from_config(setup):
    jcfg, tcfg, _p, _m = setup
    js = jreg.PipelineStatics.from_config(jcfg)
    ts = treg.PipelineStatics.from_config(tcfg)
    for name in ts.__dataclass_fields__:
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.mxu_gather and ts.strat_ball_query and ts.radius_subsample == 4


def test_precompute_matches(setup):
    jcfg, tcfg, _p, _m = setup
    jsrc, jtgt, tsrc, ttgt, _T = _pair(0, jcfg, tcfg)
    jst = jreg.PipelineStatics.from_config(jcfg)
    tst = treg.PipelineStatics.from_config(tcfg)
    keys, draws = _jax_draws(jax.random.PRNGKey(7), jst)
    jpre = jax.jit(jreg._precompute, static_argnums=(0, 4))(
        jst, jsrc, jtgt, keys[1], (0, 1, 2))
    # the port's precompute takes a batch: here the batch of one, whose two
    # clouds are stacked source first
    tpre = treg._precompute(tst, treg.stack_clouds([tsrc]),
                            treg.stack_clouds([ttgt]),
                            treg.stack_draws([draws]), (0, 1, 2),
                            keep_d2=True)
    np.testing.assert_array_equal(tpre.radii[0].numpy(),
                                  np.asarray(jpre.radii))
    for c, side in enumerate(("src", "tgt")):
        for name in ("kpts", "kpts_v"):
            np.testing.assert_array_equal(
                getattr(tpre, name)[c].numpy(),
                np.asarray(getattr(jpre, f"{side}_{name}")), name)
        np.testing.assert_allclose(tpre.d2[c].numpy(),
                                   np.asarray(getattr(jpre, f"d2_{side}")),
                                   rtol=0, atol=1e-4)
        jv = np.asarray(getattr(jpre, f"{side}_pvalid"))
        tv = tpre.pvalid[c].numpy()
        assert (jv != tv).mean() <= 0.01
        both = (jv & tv)[..., None]
        np.testing.assert_allclose(
            np.where(both, tpre.patches[c].numpy(), 0),
            np.where(both, np.asarray(getattr(jpre, f"{side}_patches")), 0),
            rtol=0, atol=1e-6)


def _check_register_pair(setup, i):
    jcfg, tcfg, params, models = setup
    jsrc, jtgt, tsrc, ttgt, T = _pair(i, jcfg, tcfg)
    jst = jreg.PipelineStatics.from_config(jcfg)
    key = jax.random.PRNGKey(100 + i)
    _keys, draws = _jax_draws(key, jst)
    jres = jreg.register_pair_jit(params, jst, jsrc, jtgt, jnp.asarray(False),
                                  key)
    tres = treg.register_pair(tcfg, tsrc, ttgt, models, draws=draws,
                              device="cpu")
    jpose = torch.from_numpy(np.array(jres.pose))
    assert tres.pose.shape == (4, 4) and bool(torch.isfinite(tres.pose).all())
    assert float(se3.compute_rte(tres.pose, jpose)) <= 0.02
    assert float(se3.compute_rre(tres.pose, jpose)) <= 2.0
    Tg = torch.from_numpy(T)

    def success(pose):
        return (float(se3.compute_rte(pose, Tg)) < tcfg.test.rte_thresh
                and float(se3.compute_rre(pose, Tg)) < tcfg.test.rre_thresh)

    assert success(tres.pose) == success(jpose)
    assert bool(tres.valid) == bool(jres.valid)
    n_mutual = int(jres.num_mutual)
    assert abs(int(tres.num_mutual) - n_mutual) <= 0.1 * n_mutual


@pytest.mark.parametrize("i", [0, 1, 2])
def test_register_pair_matches(setup, i):
    _check_register_pair(setup, i)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_register_pair_sampled_fused_matches(sampled_setup, i):
    _check_register_pair(sampled_setup, i)


@pytest.mark.parametrize("snap", ["hard_moments_r4", "r5_w2_scratch"])
def test_register_pair_other_snapshots_match(snap):
    """Serving with the softmax-pool and the width-2.0 checkpoints, each
    configured from its config.json, against ``register_pair_jit``."""
    root = os.path.join(os.path.dirname(SNAP), snap)
    jcfg = jax_make_cfg("ModelNet40").override(**SMALL)
    tcfg = make_cfg("ModelNet40").override(**SMALL)
    knobs = load_snapshot_config(root)
    jcfg = jcfg.override(patch=knobs)
    tcfg = tcfg.override(patch=knobs)
    params = {}
    for stage in ("Desc", "Pose"):
        with open(os.path.join(root, stage, "best.msgpack"), "rb") as f:
            params[stage.lower()] = jax.tree.map(
                jnp.asarray, flax.serialization.msgpack_restore(f.read()))
    models = treg.build_models(treg.PipelineStatics.from_config(tcfg),
                               load_snapshot(root), "cpu")
    _check_register_pair((jcfg, tcfg, params, models), 0)


def test_sampled_descriptor_sub_batches(sampled_setup, monkeypatch):
    """A batch with more patches than ``SAMPLED_DESC_CHUNK`` goes through
    the descriptor net in sub-batches (here 100, 100 and 56 of 256 patches a
    scale): the net's outputs are the unsplit call's (1e-5, one patch's
    values do not depend on its neighbours in the call), and the pair's
    result is the unsplit run's."""
    _j, tcfg, _p, models = sampled_setup
    tst = treg.PipelineStatics.from_config(tcfg)
    g = tst.rad_n * tst.ele_n * tst.azi_n
    inv = torch.from_numpy(np.random.RandomState(5).uniform(
        -1, 1, (2 * tst.num_fps, g, tst.voxel_sample, 3)).astype(np.float32))
    if tst.use_bf16:
        inv = inv.to(torch.bfloat16)
    whole = treg._describe(models, tst, inv)
    s, t, _T = synthetic_pair_full_overlap(np.random.RandomState(3), 2000)
    src = treg.prepare_cloud(s, tcfg, seed=3, device="cpu")
    tgt = treg.prepare_cloud(t, tcfg, seed=3, device="cpu")
    draws = treg.make_draws(tst, torch.Generator().manual_seed(3), "cpu")
    res = treg.register_pair(tcfg, src, tgt, models, draws=draws,
                             device="cpu")

    calls = []
    desc = models.desc
    monkeypatch.setattr(treg, "SAMPLED_DESC_CHUNK", 100)
    monkeypatch.setattr(
        treg, "_describe",
        lambda m, st, x, inner=treg._describe: inner(m._replace(
            desc=lambda part: (calls.append(part.shape[0]), desc(part))[1]),
            st, x))
    parts = treg._describe(models, tst, inv)
    assert calls == [100, 100, 56]
    assert set(parts) == set(whole)
    for key in whole:
        assert parts[key].shape == whole[key].shape
        np.testing.assert_allclose(parts[key].float().numpy(),
                                   whole[key].float().numpy(),
                                   rtol=0, atol=1e-5, err_msg=key)
    del calls[:]
    res_parts = treg.register_pair(tcfg, src, tgt, models, draws=draws,
                                   device="cpu")
    assert calls == [100, 100, 56] * tst.num_scales
    assert float(se3.compute_rte(res_parts.pose, res.pose)) <= 1e-4
    assert float(se3.compute_rre(res_parts.pose, res.pose)) <= 1e-2
    n_in = int(res.num_inliers)
    assert abs(int(res_parts.num_inliers) - n_in) <= max(1, 0.01 * n_in)


def test_register_pair_device_policy(setup, monkeypatch):
    _j, tcfg, _p, models = setup
    s, t, _T = synthetic_pair_full_overlap(np.random.RandomState(0), 500)
    src = treg.prepare_cloud(s, tcfg, device="cpu")
    tgt = treg.prepare_cloud(t, tcfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        treg.register_pair(tcfg, src, tgt, models)           # cuda by default
    with pytest.raises(NotImplementedError):
        treg.register_pair(tcfg.override(match=dict(pose_estimator="teaser")),
                           src, tgt, models, device="cpu")
    # default draws come from a seeded generator: deterministic
    a = treg.register_pair(tcfg, src, tgt, models, device="cpu")
    b = treg.register_pair(tcfg, src, tgt, models,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(a.pose, b.pose)


@pytest.mark.parametrize("which", ["src", "both"])
def test_empty_cloud_gives_identity(setup, which):
    jcfg, tcfg, params, models = setup
    _s, t, _T = synthetic_pair_full_overlap(np.random.RandomState(1), 1500)
    empty = np.zeros((0, 3), np.float32)
    src_pts, tgt_pts = empty, (empty if which == "both" else t)
    tres = treg.register_pair(
        tcfg, treg.prepare_cloud(src_pts, tcfg, device="cpu"),
        treg.prepare_cloud(tgt_pts, tcfg, device="cpu"), models, device="cpu")
    jres = jreg.register_pair_jit(
        params, jreg.PipelineStatics.from_config(jcfg),
        jreg.prepare_cloud(src_pts, jcfg), jreg.prepare_cloud(tgt_pts, jcfg),
        jnp.asarray(False), jax.random.PRNGKey(0))
    assert not bool(tres.valid) and not bool(jres.valid)
    assert torch.equal(tres.pose, torch.eye(4))
    np.testing.assert_array_equal(np.asarray(jres.pose), np.eye(4))


def test_check_ported_options(setup):
    """GNC, IRLS refinement, early exit, the clutter prefilter, the softmax
    pool, a widened backbone, exact top-k, the scale scheduling knobs and
    every patch query are ported; what is not still raises, and says
    what."""
    _j, tcfg, _p, _m = setup
    for kw in (dict(match=dict(pose_estimator="gnc")),
               dict(test=dict(pose_refine=True)),
               dict(match=dict(enable_early_exit=True)),
               dict(data=dict(clutter_filter=True)),
               dict(patch=dict(desc_pool="softmax")),
               dict(patch=dict(desc_width=2.0)),
               dict(patch=dict(exact_topk=True)),
               dict(patch=dict(vmap_scales=True)),
               dict(patch=dict(scale_batch_conv=True)),
               dict(patch=dict(strat_ball_query=False)),
               dict(patch=dict(num_points_per_patch=96)),
               dict(patch=dict(num_points_per_patch=16))):
        treg._check_ported(treg.PipelineStatics.from_config(
            tcfg.override(**kw)))
    for kw, word in ((dict(patch=dict(desc_pool="max")), "desc_pool"),
                     (dict(patch=dict(desc_mode="voxel")), "desc_mode"),
                     (dict(match=dict(pose_estimator="teaser")),
                      "pose_estimator")):
        with pytest.raises(NotImplementedError, match=word):
            treg._check_ported(treg.PipelineStatics.from_config(
                tcfg.override(**kw)))


def _cluttered(points, frac, rs):
    """``points`` with ``frac`` of its size added as uniform clutter in the
    1.2x bounding box (as ``hard_pair``'s ``outlier_frac`` does)."""
    lo, hi = points.min(0), points.max(0)
    pad = 0.1 * (hi - lo)
    out = rs.uniform(lo - pad, hi + pad,
                     (int(len(points) * frac), 3)).astype(np.float32)
    return np.concatenate([points, out])


@pytest.mark.parametrize("clutter,seed", [(0.1, 13), (0.2, 23)])
def test_register_pair_clutter_filter_matches(setup, clutter, seed):
    """The clutter prefilter on (the gate's clutter cells 15 and 16 add 10%
    and 20%) with 256 keypoints, against ``register_pair_jit`` with JAX's
    draws: poses within 0.02 m / 2 degrees, both register the pair, same
    ``scales_used`` and validity. With 128 keypoints the clutter the
    prefilter leaves (it removes ~84%) takes enough of FPS's picks that
    most such pairs end with 4-16 inliers, where a flip decides the pair;
    with 256 all of seeds 13-15 and 20-25 register on both sides, poses
    within 0.023 m / 3.2 degrees of each other (these two: 0.014 m / 1.1
    and 0.010 m / 1.1 degrees)."""
    jcfg, tcfg, params, models = setup
    over = dict(data=dict(clutter_filter=True),
                patch=dict(num_fps=256, num_points_radius_estimate=320))
    jcfg, tcfg = jcfg.override(**over), tcfg.override(**over)
    rs = np.random.RandomState(seed)
    s, t, T = synthetic_pair_full_overlap(rs, 1600)
    s, t = _cluttered(s, clutter, rs), _cluttered(t, clutter, rs)
    jst = jreg.PipelineStatics.from_config(jcfg)
    key = jax.random.PRNGKey(7)
    _keys, draws = _jax_draws(key, jst)
    jres = jreg.register_pair_jit(
        params, jst, jreg.prepare_cloud(s, jcfg, seed=1),
        jreg.prepare_cloud(t, jcfg, seed=2), jnp.asarray(False), key)
    tres = treg.register_pair(
        tcfg, treg.prepare_cloud(s, tcfg, seed=1, device="cpu"),
        treg.prepare_cloud(t, tcfg, seed=2, device="cpu"), models,
        draws=draws, device="cpu")
    jpose = torch.from_numpy(np.array(jres.pose))
    assert float(se3.compute_rte(tres.pose, jpose)) <= 0.02
    assert float(se3.compute_rre(tres.pose, jpose)) <= 2.0
    Tg = torch.from_numpy(T)
    for pose in (tres.pose, jpose):
        assert float(se3.compute_rte(pose, Tg)) < tcfg.test.rte_thresh
        assert float(se3.compute_rre(pose, Tg)) < tcfg.test.rre_thresh
    assert int(tres.scales_used) == int(jres.scales_used) == 3
    assert bool(tres.valid) == bool(jres.valid)
