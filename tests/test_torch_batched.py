"""Port parity: batched two-phase serving (``register_pairs_batched``) and
the batched internals, at a small size (2048 points, 128 keypoints, 160
probes, 64-point patches, 256 hypotheses), ``hard_moments_r4ft2`` weights,
bf16.

Against the JAX package: 5 pairs at batch size 4 (so the JAX side pads its
last batch and its redo batches; the port pads nothing), with the
early-exit threshold at 10**6 (every pair redone with all scales), at 1
(every pair exits at scale 0) and at 34 (two pairs of the first batch are
redone, in redo slots other than their own). The port is fed JAX's own draws: per
batch the keys as ``register_pairs_batched`` splits them, per pair the
strip offsets and RANSAC ranks that a one-scale program (phase 1) and a
three-scale program (phase 2, by redo SLOT) derive from its key. Poses agree
to 0.02 m / 2 degrees (measured: 4.7 mm, 0.66 degrees at most), success and
``scales_used`` are equal pair by pair.

Against the port's own ``register_pair``, pair by pair with the same draws,
B = 3: on the CPU the batched products give the same bits (measured: equal
mutual counts, poses equal bit for bit), held here to 1% of the mutual
matches,
0.02 m / 2 degrees and equal success; on the card ``chip_smoke.py``
measures the same comparison, where ``bmm`` may order its sums differently.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.config import make_cfg as jax_make_cfg
from bufferx_tpu.pipeline import registration as jreg
from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu_torch.pipeline import registration as treg
from bufferx_tpu_torch.tools.weights import load_snapshot
from test_torch_pipeline import SMALL, SNAP, _jax_draws, few_threads  # noqa: F401

N_PAIRS, BATCH = 5, 4
# early-exit thresholds. Scale 0's solves find 38, 29, 39, 19 and 42 inliers
# (the port; the JAX package within 1 of each): 34 sends pairs 1 and 3 on to
# all scales, as redo slots 0 and 1 of the first batch
MODES = {"redo": 10**6, "exit": 1, "mixed": 34}
SCALES_USED = {"redo": [3] * 5, "exit": [1] * 5, "mixed": [1, 3, 1, 3, 1]}


def _batch_draws(key, statics, n_pairs, batch):
    """Per batch (phase-1 draws, phase-2 draws), from ``key`` as the JAX
    ``register_pairs_batched`` splits it: a batch's pair j takes key j of its
    batch in phase 1, and redo slot r key r in phase 2."""
    out = []
    for start in range(0, n_pairs, batch):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, batch)
        size = min(batch, n_pairs - start)
        out.append(tuple(
            treg.stack_draws([_jax_draws(keys[j], statics, num_scales)[1]
                              for j in range(size)])
            for num_scales in (1, statics.num_scales)))
    return out


@pytest.fixture(scope="module")
def world():
    """Configurations, weights, the pairs on both sides, and both sides'
    results in both modes (one JAX compilation per program, shared)."""
    jcfg = jax_make_cfg("ModelNet40").override(**SMALL)
    tcfg = make_cfg("ModelNet40").override(**SMALL)
    params = {}
    for stage in ("Desc", "Pose"):
        with open(os.path.join(SNAP, stage, "best.msgpack"), "rb") as f:
            params[stage.lower()] = jax.tree.map(
                jnp.asarray, flax.serialization.msgpack_restore(f.read()))
    tstat = treg.PipelineStatics.from_config(tcfg)
    models = treg.build_models(tstat, load_snapshot(SNAP), "cpu")
    pairs = []
    for i in range(N_PAIRS):
        s, t, T = synthetic_pair_full_overlap(np.random.RandomState(i), 2000)
        pairs.append(dict(
            js=jreg.prepare_cloud(s, jcfg, seed=i),
            jt=jreg.prepare_cloud(t, jcfg, seed=i),
            ts=treg.prepare_cloud(s, tcfg, seed=i, device="cpu"),
            tt=treg.prepare_cloud(t, tcfg, seed=i, device="cpu"),
            T=torch.from_numpy(T)))
    key = jax.random.PRNGKey(0)
    draws = _batch_draws(key, jreg.PipelineStatics.from_config(jcfg),
                         N_PAIRS, BATCH)
    results = {}
    for mode, threshold in MODES.items():
        over = dict(match=dict(early_exit_min_inliers=threshold))
        jres = jreg.register_pairs_batched(
            jcfg.override(**over), [p["js"] for p in pairs],
            [p["jt"] for p in pairs], key, params, False, batch_size=BATCH)
        tres = treg.register_pairs_batched(
            tcfg.override(**over), [p["ts"] for p in pairs],
            [p["tt"] for p in pairs], models, batch_size=BATCH, draws=draws,
            device="cpu")
        results[mode] = (jres, tres)
    return dict(tcfg=tcfg, tstat=tstat, models=models, pairs=pairs,
                draws=draws, results=results)


def _success(cfg, pose, T):
    return (float(se3.compute_rte(pose, T)) < cfg.test.rte_thresh
            and float(se3.compute_rre(pose, T)) < cfg.test.rre_thresh)


@pytest.mark.parametrize("i", range(N_PAIRS))
@pytest.mark.parametrize("mode", list(MODES))
def test_register_pairs_batched_matches_jax(world, mode, i):
    jres, tres = world["results"][mode]
    assert len(jres) == len(tres) == N_PAIRS
    j, t, T = jres[i], tres[i], world["pairs"][i]["T"]
    assert int(t.scales_used) == int(j.scales_used) == SCALES_USED[mode][i]
    jpose = torch.from_numpy(np.array(j.pose))
    assert t.pose.shape == (4, 4) and bool(torch.isfinite(t.pose).all())
    assert float(se3.compute_rte(t.pose, jpose)) <= 0.02
    assert float(se3.compute_rre(t.pose, jpose)) <= 2.0
    cfg = world["tcfg"]
    assert _success(cfg, t.pose, T) == _success(cfg, jpose, T)
    assert bool(t.valid) == bool(j.valid)
    n_mutual = int(j.num_mutual)
    assert abs(int(t.num_mutual) - n_mutual) <= 0.1 * n_mutual
    if mode == "redo":      # all scales: the pair registers
        assert _success(cfg, t.pose, T)


@pytest.mark.parametrize("mode", ["redo"])
def test_no_padding_changes_a_result(world, mode):
    """The fifth pair runs in a batch of its own (the JAX side pads that
    batch with three copies): the same pair registered alone, and all five
    in one batch of 5, give the same pose (same draws; 1e-4 for the order of
    batched sums)."""
    tcfg = world["tcfg"].override(
        match=dict(early_exit_min_inliers=MODES[mode]))
    pairs, models, draws = world["pairs"], world["models"], world["draws"]
    _jres, tres = world["results"][mode]
    alone = treg.register_pairs_batched(
        tcfg, [pairs[4]["ts"]], [pairs[4]["tt"]], models, batch_size=BATCH,
        draws=[draws[1]], device="cpu")
    assert torch.equal(alone[0].pose, tres[4].pose)
    # one batch of 5: pair j takes the phase-1 draws it had; every pair is
    # redone or none is, so redo slot j is pair j, and pair 4, slot 0 of its
    # own redo batch before, takes those draws again as slot 4
    one = [tuple(treg.Draws(*(torch.cat([a, b]) for a, b in zip(d0, d1)))
                 for d0, d1 in zip(draws[0], draws[1]))]
    together = treg.register_pairs_batched(
        tcfg, [p["ts"] for p in pairs], [p["tt"] for p in pairs], models,
        batch_size=5, draws=one, device="cpu")
    for i in range(N_PAIRS):
        np.testing.assert_allclose(together[i].pose.numpy(),
                                   tres[i].pose.numpy(), rtol=0, atol=1e-4)
        assert int(together[i].scales_used) == int(tres[i].scales_used)


def test_batched_internals_match_register_pair(world):
    """A batch of 3 through all scales against ``register_pair`` on each
    pair with the same draws."""
    cfg, tstat, models = world["tcfg"], world["tstat"], world["models"]
    pairs = world["pairs"][:3]
    draws = treg.Draws(*(x[:3] for x in world["draws"][0][1]))
    batch = treg._register_batch(
        models, tstat, treg.stack_clouds([p["ts"] for p in pairs]),
        treg.stack_clouds([p["tt"] for p in pairs]), draws, (0, 1, 2), False)
    assert batch.pose.shape == (3, 4, 4)
    for i, p in enumerate(pairs):
        single = treg.register_pair(
            cfg, p["ts"], p["tt"], models,
            draws=treg.Draws(*(x[i] for x in draws)), device="cpu")
        n = int(single.num_mutual)
        assert abs(int(batch.num_mutual[i]) - n) <= 0.01 * n
        assert float(se3.compute_rte(batch.pose[i], single.pose)) <= 0.02
        assert float(se3.compute_rre(batch.pose[i], single.pose)) <= 2.0
        assert (_success(cfg, batch.pose[i], p["T"])
                == _success(cfg, single.pose, p["T"]))
        assert int(batch.scales_used[i]) == int(single.scales_used) == 3


class _HostReads:
    """Counts the ways Python can read a tensor's value: ``item``,
    ``tolist``, ``numpy``, ``cpu``, the conversions to bool, int, float and
    index, ``nonzero`` and indexing by a bool mask (whose result size is a
    value read back on the card)."""

    NAMES = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
             "__float__", "__index__", "nonzero")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in self.NAMES:
            monkeypatch.setattr(torch.Tensor, name,
                                self._counting(name, getattr(torch.Tensor,
                                                             name)))
        inner = torch.Tensor.__getitem__

        def getitem(tensor, index):
            for part in index if isinstance(index, tuple) else (index,):
                if isinstance(part, torch.Tensor) and part.dtype == torch.bool:
                    self.calls.append("mask index")
            return inner(tensor, index)

        monkeypatch.setattr(torch.Tensor, "__getitem__", getitem)

    def _counting(self, name, inner):
        def wrapped(*args, **kwargs):
            self.calls.append(name)
            return inner(*args, **kwargs)
        return wrapped


@pytest.mark.parametrize("mode,batches_redone", [("exit", 0), ("redo", 2)])
def test_one_host_read_per_batch(world, monkeypatch, mode, batches_redone):
    """Phase 1 reads nothing back; phase 2 reads each batch's inlier counts
    in one transfer, and nothing else in the function reads a value."""
    tcfg = world["tcfg"].override(
        match=dict(early_exit_min_inliers=MODES[mode]))
    pairs, models, draws = world["pairs"], world["models"], world["draws"]
    reads = _HostReads(monkeypatch)
    fetches = []
    inner_fetch = treg._fetch_inliers

    def fetch(res):
        fetches.append(list(reads.calls))     # the reads made before it
        before = len(reads.calls)
        out = inner_fetch(res)
        assert reads.calls[before:] == ["tolist"]
        del reads.calls[before:]
        return out

    monkeypatch.setattr(treg, "_fetch_inliers", fetch)
    launched = []
    inner_batch = treg._register_batch

    def register_batch(models_, statics, src, tgt, batch_draws, scales,
                       is_aligned):
        launched.append((scales, src.xyz.shape[0], len(fetches)))
        return inner_batch(models_, statics, src, tgt, batch_draws, scales,
                           is_aligned)

    monkeypatch.setattr(treg, "_register_batch", register_batch)
    out = treg.register_pairs_batched(
        tcfg, [p["ts"] for p in pairs], [p["tt"] for p in pairs], models,
        batch_size=BATCH, draws=draws, device="cpu")
    assert len(out) == N_PAIRS
    assert len(fetches) == 2                  # one per batch
    assert reads.calls == []                  # and no other read at all
    # both scale-0 batches are launched before the first read
    assert launched[:2] == [((0,), 4, 0), ((0,), 1, 0)]
    # the redo batches are not padded: 4 pairs and 1 pair
    assert launched[2:] == [((0, 1, 2), 4, 1), ((0, 1, 2), 1, 2)][
        :batches_redone]


def test_tensor_flags_match_the_bool_flag(world, monkeypatch):
    """A [5] bool tensor of False flags takes the tensor path (both LRF
    branches, ``torch.where`` a patch) and gives the bool False run's
    results to the bit, at the threshold whose redo batch takes pairs 1
    and 3 (each pair's flag follows it into its redo slot); the flags are
    read back nowhere (one host read a batch, as with a bool)."""
    tcfg = world["tcfg"].override(
        match=dict(early_exit_min_inliers=MODES["mixed"]))
    pairs, models, draws = world["pairs"], world["models"], world["draws"]
    _jres, want = world["results"]["mixed"]
    reads = _HostReads(monkeypatch)
    out = treg.register_pairs_batched(
        tcfg, [p["ts"] for p in pairs], [p["tt"] for p in pairs], models,
        batch_size=BATCH, draws=draws, is_aligned=torch.zeros(N_PAIRS,
                                                              dtype=torch.bool),
        device="cpu")
    assert reads.calls == ["tolist", "tolist"]
    monkeypatch.undo()
    assert [int(r.scales_used) for r in out] == SCALES_USED["mixed"]
    for got, ref in zip(out, want):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="a flag a pair"):
        treg.register_pairs_batched(
            tcfg, [p["ts"] for p in pairs], [p["tt"] for p in pairs], models,
            batch_size=BATCH, draws=draws,
            is_aligned=torch.zeros(BATCH, dtype=torch.bool), device="cpu")
