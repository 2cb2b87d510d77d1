"""Port parity: the serving variants of single-pair registration against
the JAX package, at the small size of ``test_torch_pipeline.py`` (whose
fixtures and helpers are used here) and with JAX's own draws: masked early
exit in ``register_pair``, host-dispatched ``register_pair_early_exit``,
the three-phase ``register_pair_timed`` with and without IRLS refinement,
and the GNC-TLS solver end to end. Poses agree to 0.02 m / 2 degrees,
success, validity and ``scales_used`` are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.pipeline import registration as jreg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.pipeline import registration as treg
from test_torch_pipeline import _jax_draws, _pair, few_threads, setup  # noqa: F401


def _assert_close_to_jax(tcfg, tres, jres, T):
    """Poses within 0.02 m / 2 degrees, success and validity equal."""
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


# scale 0's solve finds 20 and 43 inliers on pairs 3 and 4 (the port, with
# these draws): a threshold of 28 sends pair 3 on to all scales and lets
# pair 4 exit, with a margin of 8 inliers or more for the JAX side
@pytest.mark.parametrize("i,scales_used", [(3, 3), (4, 1)])
def test_masked_early_exit_matches(setup, i, scales_used):
    jcfg, tcfg, params, models = setup
    over = dict(match=dict(enable_early_exit=True, early_exit_min_inliers=28))
    jcfg, tcfg = jcfg.override(**over), tcfg.override(**over)
    jsrc, jtgt, tsrc, ttgt, T = _pair(i, jcfg, tcfg)
    jst = jreg.PipelineStatics.from_config(jcfg)
    key = jax.random.PRNGKey(100 + i)
    _keys, draws = _jax_draws(key, jst)
    jres = jreg.register_pair_jit(params, jst, jsrc, jtgt, jnp.asarray(False),
                                  key)
    tres = treg.register_pair(tcfg, tsrc, ttgt, models, draws=draws,
                              device="cpu")
    assert int(tres.scales_used) == int(jres.scales_used) == scales_used
    _assert_close_to_jax(tcfg, tres, jres, T)


@pytest.mark.parametrize("i,threshold,scales_used",
                         [(4, 28, 1), (3, 28, 3)])
def test_register_pair_early_exit_matches(setup, i, threshold, scales_used):
    """Host-dispatched early exit: both sides run scale 0 with the draws of
    a one-scale program, then, if unconfident, all scales with the draws of
    a three-scale program from the same key."""
    jcfg, tcfg, params, models = setup
    over = dict(match=dict(early_exit_min_inliers=threshold))
    jcfg, tcfg = jcfg.override(**over), tcfg.override(**over)
    jsrc, jtgt, tsrc, ttgt, T = _pair(i, jcfg, tcfg)
    jst = jreg.PipelineStatics.from_config(jcfg)
    key = jax.random.PRNGKey(100 + i)
    draws = (_jax_draws(key, jst, num_scales=1)[1], _jax_draws(key, jst)[1])
    jres = jreg.register_pair_early_exit(jcfg, jsrc, jtgt, key, params, False)
    tres = treg.register_pair_early_exit(tcfg, tsrc, ttgt, models,
                                         draws=draws, device="cpu")
    assert int(tres.scales_used) == int(jres.scales_used) == scales_used
    _assert_close_to_jax(tcfg, tres, jres, T)


@pytest.mark.parametrize("refine", [False, True])
def test_register_pair_timed_matches(setup, refine):
    """The three-phase timed path against the JAX package's, with and
    without IRLS refinement; and it equals the port's untimed path to 1e-5
    (the same operations in the same order, fenced)."""
    jcfg, tcfg, params, models = setup
    over = dict(test=dict(pose_refine=refine))
    jcfg, tcfg = jcfg.override(**over), tcfg.override(**over)
    jsrc, jtgt, tsrc, ttgt, T = _pair(1, jcfg, tcfg)
    jst = jreg.PipelineStatics.from_config(jcfg)
    key = jax.random.PRNGKey(101)
    _keys, draws = _jax_draws(key, jst)
    jres, jphases = jreg.register_pair_timed(params, jst, jsrc, jtgt,
                                             jnp.asarray(False), key)
    tres, phases = treg.register_pair_timed(tcfg, tsrc, ttgt, models,
                                            draws=draws, device="cpu")
    assert sorted(phases) == sorted(jphases) == [
        "desc_time", "pose_optim_time", "pose_time"]
    assert phases["desc_time"] > 0 and phases["pose_time"] > 0
    assert (phases["pose_optim_time"] > 0) == refine
    _assert_close_to_jax(tcfg, tres, jres, T)
    untimed = treg.register_pair(tcfg, tsrc, ttgt, models, draws=draws,
                                 device="cpu")
    np.testing.assert_allclose(tres.pose.numpy(), untimed.pose.numpy(),
                               rtol=0, atol=1e-5)
    assert int(tres.num_inliers) == int(untimed.num_inliers)
    if refine:   # the refinement moved the pose, and not far
        coarse = treg.register_pair(
            tcfg.override(test=dict(pose_refine=False)), tsrc, ttgt, models,
            draws=draws, device="cpu")
        assert not torch.equal(coarse.pose, tres.pose)
        assert float(se3.compute_rte(coarse.pose, tres.pose)) < 0.02


@pytest.mark.parametrize("i", [0])
def test_register_pair_gnc_matches(setup, i):
    jcfg, tcfg, params, models = setup
    over = dict(match=dict(pose_estimator="gnc"))
    jcfg, tcfg = jcfg.override(**over), tcfg.override(**over)
    jsrc, jtgt, tsrc, ttgt, T = _pair(i, jcfg, tcfg)
    jst = jreg.PipelineStatics.from_config(jcfg)
    key = jax.random.PRNGKey(100 + i)
    _keys, draws = _jax_draws(key, jst)
    jres = jreg.register_pair_jit(params, jst, jsrc, jtgt, jnp.asarray(False),
                                  key)
    tres = treg.register_pair(tcfg, tsrc, ttgt, models, draws=draws,
                              device="cpu")
    _assert_close_to_jax(tcfg, tres, jres, T)
    n = int(jres.num_inliers)
    assert abs(int(tres.num_inliers) - n) <= 0.1 * n


def test_jax_scale0_success_count_at_full_width():
    """``chip_smoke.py`` holds the card's scale-0 runs on its first 4 pairs
    to the JAX package's success count minus 1: this is the run behind that
    count, the JAX package at full width (30208 points, 1500 keypoints,
    8192 hypotheses) with ``scales=(0,)`` and ``PRNGKey(i)`` for pair i.
    About 2 GB and half a minute on the CPU."""
    import importlib.util
    import os

    import flax
    from bufferx_tpu.config import make_cfg as jax_make_cfg
    from bufferx_tpu.data.modelnet import synthetic_pair_full_overlap
    from bufferx_tpu.train.trainer import load_snapshot_config

    root = os.path.join(os.path.dirname(__file__), "..")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    cfg = jax_make_cfg("ModelNet40").override(patch=dict(desc_mode="moments"))
    cfg = cfg.override(patch=load_snapshot_config(smoke.SNAPSHOT))
    statics = jreg.PipelineStatics.from_config(cfg)
    params = {}
    for stage in ("Desc", "Pose"):
        with open(os.path.join(smoke.SNAPSHOT, stage, "best.msgpack"),
                  "rb") as f:
            params[stage.lower()] = jax.tree.map(
                jnp.asarray, flax.serialization.msgpack_restore(f.read()))
    successes = 0
    for i in range(smoke.NUM_PAIRS):
        s, t, T = synthetic_pair_full_overlap(np.random.RandomState(i),
                                              num_points=24000)
        res = jreg.register_pair_jit(
            params, statics, jreg.prepare_cloud(s, cfg, seed=i),
            jreg.prepare_cloud(t, cfg, seed=i), jnp.asarray(False),
            jax.random.PRNGKey(i), scales=(0,))
        pose, Tg = torch.from_numpy(np.array(res.pose)), torch.from_numpy(T)
        successes += (float(se3.compute_rte(pose, Tg)) < cfg.test.rte_thresh
                      and float(se3.compute_rre(pose, Tg))
                      < cfg.test.rre_thresh)
    assert successes == smoke.JAX_SUCCESSES["moments_scale0"] == 4
