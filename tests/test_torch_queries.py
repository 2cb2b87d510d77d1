"""Port parity for the patch queries that the fused stratified query (kernel
K2) does not serve, and for the pipeline that runs them.

Queries, on seeded clouds against the JAX package's functions with its own
random offsets: the flat ``ball_query`` (equal indices with and without a
precomputed d2, and with a leading cloud dimension), ``ball_query_blocks``
(bit-equal patches on the same d2; on the port's own f32 d2 the level-1
block counts round differently from the JAX package's compensated one, and
the slots that flip are counted and bounded), the single-radius
``ball_query_stratified`` (bit-equal), ``select_patches``' dispatch and its
two fallback warnings, and ``voxel_downsample`` (overflow included).

Pipeline, at the small size of ``test_torch_pipeline.py``, against
``register_pair_jit`` with JAX's draws: ``strat_ball_query=False`` with the
block query on and off, a patch size that does not divide ``max_points``,
``max_points / patch_size >= 128`` (the single-radius query), each on the
moments path and the first two on the sampled + fused path; a batch of two
with the block query; ``exact_topk`` (changes nothing), ``vmap_scales`` and
``scale_batch_conv`` (the port runs the default's chain for both). Poses
agree within the port's
0.02 m / 2 degrees; where the path is exact (the same draws through the
same port code) they are equal.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.geometry.patches import select_patches as jax_select_patches
from bufferx_tpu.kernels import neighbors as jnb
from bufferx_tpu.kernels.voxel import voxel_downsample as jax_voxel_downsample
from bufferx_tpu.pipeline import registration as jreg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu_torch.geometry.patches import patch_query, select_patches
from bufferx_tpu_torch.kernels import neighbors as tnb
from bufferx_tpu_torch.kernels.voxel import voxel_downsample
from bufferx_tpu_torch.pipeline import registration as treg
from test_torch_pipeline import (  # noqa: F401
    _pair,
    few_threads,
    sampled_setup,
    setup,
)

# slots of the block query whose validity or point changes when the port's
# own f32 d2 replaces the JAX package's compensated one: measured 0 of the
# 16384 slots here (seed 1 has one in-radius test of 131072 that flips on
# d2, and the level-1 test's widened radius absorbs it). A flip at level 1
# moves a block in or out of the candidates and reorders the slots after
# it, so the bound leaves room for a few such blocks
BLOCK_FLIP_BOUND = 1e-3


def _cloud(seed, n=2048, k=64):
    rs = np.random.RandomState(seed)
    pts = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    mask = rs.rand(n) < 0.9
    centers = pts[rs.choice(n, k, replace=False)]
    return pts, mask, centers


def _jax_d2(pts, mask, centers):
    return np.asarray(jnb.masked_sqdist(
        jnp.asarray(centers), jnp.asarray(pts),
        jnp.ones(len(centers), bool), jnp.asarray(mask), precise=False))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _flat_off(key, k, n):
    return np.array(jax.random.randint(key, (k, 1), 0, n))[:, 0]


def _block_off(key, k, n, block, cand_blocks):
    k1, k2 = jax.random.split(key)
    nb = n // block
    cb = min(cand_blocks, nb)
    return np.stack([_flat_off(k1, k, nb), _flat_off(k2, k, cb * block)])


def _strat_off(key, k, n, s):
    return np.array(jax.random.randint(key, (k, 1, s), 0, n // s))[:, 0]


def jax_scale_draws(key, statics, kind):
    """The per-scale draws ``register_pair_jit`` makes from ``key`` when the
    fused query does not run (``kind``: the query ``select_patches`` picks):
    scale j's offsets from ``keys[4 + 2 j]``, split into the source's and
    the target's, as ``_embed_geom`` splits it."""
    keys = jax.random.split(key, 4 + 2 * statics.num_scales)
    nf, n = statics.num_fps, statics.max_points
    per = []
    for j in range(statics.num_scales):
        clouds = []
        for kc in jax.random.split(keys[4 + 2 * j]):
            if kind == "flat":
                clouds.append(_flat_off(kc, nf, n))
            elif kind == "blocks":
                clouds.append(_block_off(kc, nf, n, statics.bq_block,
                                         statics.bq_cand_blocks))
            else:
                clouds.append(_strat_off(kc, nf, n, statics.patch_sample))
        per.append(np.stack(clouds))
    ranks = np.array(jax.random.randint(
        keys[0], (statics.num_hypotheses, 3), 0, jnp.int32(1 << 30),
        dtype=jnp.int32))
    return treg.ScaleDraws(torch.from_numpy(np.stack(per)),
                           torch.from_numpy(ranks))


# ---- the queries ------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_flat_query_with_and_without_d2(seed):
    pts, mask, centers = _cloud(seed)
    d2 = _jax_d2(pts, mask, centers)
    key = jax.random.PRNGKey(seed)
    r = np.float32(0.3)
    j_idx, j_valid = jnb.ball_query(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(centers), r, key, 64,
        use_approx=False, d2=jnp.asarray(d2))
    off = torch.from_numpy(_flat_off(key, len(centers), len(pts)))
    tp, tm, tc, td2 = _t(pts, mask, centers, d2)
    idx, valid = tnb.ball_query(tp, tm, tc, torch.tensor(r), off, 64, d2=td2)
    assert np.array_equal(np.asarray(j_idx), idx.numpy())
    assert np.array_equal(np.asarray(j_valid), valid.numpy())
    # without d2 the query builds the same matrix the caller would pass
    own = tnb.ball_query(tp, tm, tc, torch.tensor(r), off, 64,
                         d2=tnb.sqdist(tc, tp))
    idx2, valid2 = tnb.ball_query(tp, tm, tc, torch.tensor(r), off, 64)
    assert torch.equal(own[0], idx2) and torch.equal(own[1], valid2)
    # a leading cloud dimension: two clouds, one radius each
    idx3, valid3 = tnb.ball_query(
        torch.stack([tp, tp.flip(0)]), torch.stack([tm, tm.flip(0)]),
        torch.stack([tc, tc]), torch.tensor([r, 0.2]), torch.stack([off, off]),
        64)
    assert torch.equal(idx3[0], idx2) and torch.equal(valid3[0], valid2)
    alone = tnb.ball_query(tp.flip(0), tm.flip(0), tc, 0.2, off, 64)
    assert torch.equal(idx3[1], alone[0])


@pytest.mark.parametrize("seed,block,cand", [(0, 32, 64), (1, 8, 16)])
def test_block_query_bit_equal(seed, block, cand):
    pts, mask, centers = _cloud(seed)
    d2 = _jax_d2(pts, mask, centers)
    key = jax.random.PRNGKey(10 + seed)
    r = np.float32(0.35)
    jp, jv = jnb.ball_query_blocks(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(centers), r, key,
        64, jnp.asarray(d2), block=block, cand_blocks=cand)
    off = torch.from_numpy(_block_off(key, len(centers), len(pts), block,
                                      cand))
    tp, tm, tc, td2 = _t(pts, mask, centers, d2)
    p, v = tnb.ball_query_blocks(tp, tm, tc, torch.tensor(r), off, 64, td2,
                                 block=block, cand_blocks=cand)
    assert np.array_equal(np.asarray(jv), v.numpy())
    assert np.array_equal(np.asarray(jp), p.numpy())
    assert 0.05 < float(v.float().mean()) < 0.95      # both kinds of slot
    # a leading cloud dimension gives each cloud's own result
    p2, v2 = tnb.ball_query_blocks(
        torch.stack([tp, tp]), torch.stack([tm, tm]), torch.stack([tc, tc]),
        torch.tensor([r, r]), torch.stack([off, off]), 64,
        torch.stack([td2, td2]), block=block, cand_blocks=cand)
    assert torch.equal(p2[1], p) and torch.equal(v2[1], v)


def test_block_query_flip_rate_on_the_ports_d2():
    """On the port's own d2 (centred f32 expansion) against the JAX
    package's compensated one: the slots that differ are counted."""
    flips = total = 0
    for seed in range(4):
        pts, mask, centers = _cloud(seed)
        key = jax.random.PRNGKey(20 + seed)
        r = np.float32(0.3)
        jp, jv = jnb.ball_query_blocks(
            jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(centers), r,
            key, 64, jnp.asarray(_jax_d2(pts, mask, centers)), block=32,
            cand_blocks=64)
        tp, tm, tc = _t(pts, mask, centers)
        cen = tp[tm].mean(0)
        d2 = tnb.masked_sqdist(tc - cen, tp - cen,
                               torch.ones(len(centers), dtype=torch.bool), tm)
        off = torch.from_numpy(_block_off(key, len(centers), len(pts), 32, 64))
        p, v = tnb.ball_query_blocks(tp, tm, tc, torch.tensor(r), off, 64, d2,
                                     block=32, cand_blocks=64)
        same = (np.asarray(jv) == v.numpy()) & np.all(
            np.asarray(jp) == p.numpy(), axis=-1)
        flips += int((~same).sum())
        total += same.size
    assert flips <= BLOCK_FLIP_BOUND * total, (flips, total)


@pytest.mark.parametrize("n,s", [(2048, 64), (2048, 16), (4096, 16)])
def test_single_radius_stratified_bit_equal(n, s):
    """Strips of 32, 128 and 256 points (the last two are the shapes that
    the fused query's packed words cannot hold)."""
    pts, mask, centers = _cloud(n % 7, n=n)
    d2 = _jax_d2(pts, mask, centers)
    key = jax.random.PRNGKey(n + s)
    r = np.float32(0.25)
    jp, jv = jnb.ball_query_stratified(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(centers), r, key, s,
        jnp.asarray(d2))
    off = torch.from_numpy(_strat_off(key, len(centers), n, s))
    tp, tm, tc, td2 = _t(pts, mask, centers, d2)
    p, v = tnb.ball_query_stratified(tp, tm, tc, torch.tensor(r), off, s, td2)
    assert np.array_equal(np.asarray(jv), v.numpy())
    assert np.array_equal(np.asarray(jp), p.numpy())
    assert 0 < float(v.float().mean()) < 1


@pytest.mark.parametrize("case", [
    # (n, patch_sample, use_strat, use_blocks, with d2) -> query, warnings
    (2048, 64, True, True, True),      # the stratified query
    (2048, 96, True, True, True),      # 2048 % 96: warns, then blocks
    (2048, 96, True, False, True),     # warns, then flat
    (2048, 64, True, True, False),     # no d2: both warn, then flat
    (2048, 64, False, True, True),     # blocks
    (2000, 64, False, True, True),     # 2000 % 32: warns, then flat
    (2048, 64, False, False, False),   # flat, no warning
])
def test_select_patches_dispatch_and_warnings(case):
    n, s, use_strat, use_blocks, with_d2 = case
    pts, mask, centers = _cloud(3, n=n, k=32)
    d2 = _jax_d2(pts, mask, centers) if with_d2 else None
    key = jax.random.PRNGKey(5)
    r = np.float32(0.3)
    kind = patch_query(n, s, with_d2, use_blocks, 32, 64, use_strat)
    off = {"strat": lambda: _strat_off(key, 32, n, s),
           "blocks": lambda: _block_off(key, 32, n, 32, 64),
           "flat": lambda: _flat_off(key, 32, n)}[kind]()
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jp, jm = jax_select_patches(
            jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(centers), r, key,
            s, use_approx=False, d2=None if d2 is None else jnp.asarray(d2),
            use_blocks=use_blocks, use_strat=use_strat)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tp, tm, tc = _t(pts, mask, centers)
        p, m = select_patches(
            tp, tm, tc, torch.tensor(r), torch.from_numpy(off), s,
            d2=None if d2 is None else torch.from_numpy(d2),
            use_blocks=use_blocks, use_strat=use_strat)
    jmsg = [str(w.message) for w in jw if "select_patches" in str(w.message)]
    tmsg = [str(w.message) for w in tw if "select_patches" in str(w.message)]
    assert tmsg == jmsg
    assert np.array_equal(np.asarray(jm), m.numpy())
    assert np.array_equal(np.asarray(jp), p.numpy())


@pytest.mark.parametrize("capacity", [2000, 40])
def test_voxel_downsample(capacity):
    """The device voxel grid against the JAX function, with the overflow row
    taking what does not fit at capacity 40; a batch of two clouds."""
    rs = np.random.RandomState(capacity)
    xyz = rs.uniform(-1, 1, (3000, 3)).astype(np.float32)
    mask = rs.rand(3000) < 0.8
    jx, jm = jax_voxel_downsample(jnp.asarray(xyz), jnp.asarray(mask),
                                  jnp.float32(0.15), capacity)
    tx, tm = voxel_downsample(torch.from_numpy(xyz), torch.from_numpy(mask),
                              torch.tensor(0.15), capacity)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert np.array_equal(np.asarray(jx), tx.numpy())
    assert int(tm.sum()) == min(capacity, int(tm.sum()))
    bx, bm = voxel_downsample(torch.stack([tx.new_tensor(xyz[::-1].copy()),
                                           torch.from_numpy(xyz)]),
                              torch.stack([torch.from_numpy(mask[::-1].copy()),
                                           torch.from_numpy(mask)]),
                              0.15, capacity)
    assert torch.equal(bx[1], tx) and torch.equal(bm[1], tm)


# ---- the pipeline -----------------------------------------------------------
@pytest.mark.parametrize("batch", [None, 3])
def test_fused_path_draws_keep_their_stream(setup, batch):
    """Where the fused query runs, ``make_draws`` draws as it always has:
    the RANSAC ranks, then the source's and the target's strip offsets,
    from the one generator (a change of order changes every draw)."""
    tst = treg.PipelineStatics.from_config(setup[1])
    assert treg.fused_query(tst)
    got = treg.make_draws(tst, torch.Generator().manual_seed(4), "cpu",
                          batch=batch)
    gen = torch.Generator().manual_seed(4)
    ranks = treg.draw_ranks(tst.num_hypotheses, gen, "cpu",
                            batch=1 if batch is None else batch)
    shape = (() if batch is None else (batch,)) + (tst.num_fps,
                                                   tst.patch_sample)
    l = tst.max_points // tst.patch_sample
    src, tgt = (torch.randint(0, l, shape, generator=gen, dtype=torch.int32)
                for _ in range(2))
    assert type(got) is treg.Draws and len(got) == 3
    assert torch.equal(got.ransac, ranks[0] if batch is None else ranks)
    assert torch.equal(got.strat_src, src) and torch.equal(got.strat_tgt, tgt)

# two scales: scale 1 reads its own draws (keys[6]) as every later scale
# does, at two thirds of the cost of three
TWO_SCALES = dict(num_scales=2, search_radius_thresholds=(5.0, 2.0))
PATHS = {
    "no_strat_flat": (dict(patch=dict(TWO_SCALES, strat_ball_query=False)),
                      "flat"),
    "no_strat_blocks": (dict(patch=dict(TWO_SCALES, strat_ball_query=False,
                                        block_ball_query=True)), "blocks"),
    "p96": (dict(patch=dict(TWO_SCALES, num_points_per_patch=96)), "flat"),
    "p16": (dict(patch=dict(TWO_SCALES, num_points_per_patch=16)), "strat"),
}


def _register_both(setup, over, kind, i=0, key_seed=100):
    jcfg, tcfg, params, models = setup
    jcfg, tcfg = jcfg.override(**over), tcfg.override(**over)
    jsrc, jtgt, tsrc, ttgt, T = _pair(i, jcfg, tcfg)
    jst = jreg.PipelineStatics.from_config(jcfg)
    tst = treg.PipelineStatics.from_config(tcfg)
    assert not treg.fused_query(tst) and treg._scale_query(tst) == kind
    key = jax.random.PRNGKey(key_seed + i)
    draws = jax_scale_draws(key, jst, kind)
    jres = jreg.register_pair_jit(params, jst, jsrc, jtgt, jnp.asarray(False),
                                  key)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tres = treg.register_pair(tcfg, tsrc, ttgt, models, draws=draws,
                                  device="cpu")
    return tcfg, (tsrc, ttgt, draws), jres, tres, T


def _close(tres, jres, T, tcfg):
    jpose = torch.from_numpy(np.array(jres.pose))
    assert float(se3.compute_rte(tres.pose, jpose)) <= 0.02
    assert float(se3.compute_rre(tres.pose, jpose)) <= 2.0
    Tg = torch.from_numpy(T)

    def success(pose):
        return (float(se3.compute_rte(pose, Tg)) < tcfg.test.rte_thresh
                and float(se3.compute_rre(pose, Tg)) < tcfg.test.rre_thresh)

    assert success(tres.pose) and success(jpose)
    assert bool(tres.valid) == bool(jres.valid)
    assert int(tres.scales_used) == int(jres.scales_used)


@pytest.mark.parametrize("path", list(PATHS))
def test_register_pair_other_queries_match(setup, path):
    over, kind = PATHS[path]
    tcfg, _inputs, jres, tres, T = _register_both(setup, over, kind)
    _close(tres, jres, T, tcfg)


@pytest.mark.parametrize("path", ["no_strat_blocks", "p16"])
def test_register_pair_other_queries_match_sampled(sampled_setup, path):
    over, kind = PATHS[path]
    tcfg, _inputs, jres, tres, T = _register_both(sampled_setup, over, kind)
    _close(tres, jres, T, tcfg)


def test_register_batch_block_query_matches(setup):
    """A batch of two pairs with the block query: each pair as
    ``register_pair_jit`` scores it, and equal to the port's single pair."""
    over, kind = PATHS["no_strat_blocks"]
    singles = [_register_both(setup, over, kind, i=i) for i in (1, 2)]
    tcfg = singles[0][0]
    srcs = [s[1][0] for s in singles]
    tgts = [s[1][1] for s in singles]
    draws = treg.stack_draws([s[1][2] for s in singles])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        batch = treg.register_batch(tcfg, srcs, tgts, setup[3], draws=draws,
                                    device="cpu")
    for b, (_c, _i, jres, tres, T) in enumerate(singles):
        one = treg.RegistrationResult(*(x[b] for x in batch))
        _close(one, jres, T, tcfg)
        assert float(se3.compute_rte(one.pose, tres.pose)) <= 1e-4
        assert float(se3.compute_rre(one.pose, tres.pose)) <= 1e-2


def test_exact_topk_changes_nothing(setup):
    """``exact_topk`` changes no output of the port, on the flat query and
    on the fused path (every query of the port is exact; the JAX package's
    flag picks its exact top-k, which the CPU runs either way:
    ``tests/test_torch_gate.py`` holds ``--exact-topk`` against
    ``scripts/exp_hard.py``)."""
    _j, tcfg, _p, models = setup
    s, t, _T = synthetic_pair_full_overlap(np.random.RandomState(5), 2000)
    src = treg.prepare_cloud(s, tcfg, seed=5, device="cpu")
    tgt = treg.prepare_cloud(t, tcfg, seed=5, device="cpu")
    for over in (dict(strat_ball_query=False), {}):
        base = tcfg.override(patch=dict(TWO_SCALES, **over))
        draws = treg.make_draws(treg.PipelineStatics.from_config(base),
                                torch.Generator().manual_seed(1), "cpu")
        a = treg.register_pair(base, src, tgt, models, draws=draws,
                               device="cpu")
        b = treg.register_pair(base.override(patch=dict(exact_topk=True)),
                               src, tgt, models, draws=draws, device="cpu")
        assert torch.equal(a.pose, b.pose) and torch.equal(a.num_inliers,
                                                           b.num_inliers)


@pytest.mark.parametrize("knob", ["vmap_scales", "scale_batch_conv"])
def test_scale_scheduling_knobs_match(setup, knob):
    """``vmap_scales`` and ``scale_batch_conv`` against
    ``register_pair_jit`` with the same knob on (the JAX package schedules
    the scales otherwise), with JAX's draws, on the fused path; the port
    runs its default's unrolled chain for both, so its result equals the
    default's."""
    jcfg, tcfg, params, models = setup
    jcfg, tcfg = (c.override(patch=TWO_SCALES) for c in (jcfg, tcfg))
    default_cfg = tcfg
    over = dict(patch={knob: True})
    jcfg, tcfg = jcfg.override(**over), tcfg.override(**over)
    jsrc, jtgt, tsrc, ttgt, T = _pair(1, jcfg, tcfg)
    jst = jreg.PipelineStatics.from_config(jcfg)
    key = jax.random.PRNGKey(31)
    from test_torch_pipeline import _jax_draws

    _keys, draws = _jax_draws(key, jst, num_scales=jst.num_scales)
    jres = jreg.register_pair_jit(params, jst, jsrc, jtgt, jnp.asarray(False),
                                  key)
    tres = treg.register_pair(tcfg, tsrc, ttgt, models, draws=draws,
                              device="cpu")
    _close(tres, jres, T, tcfg)
    default = treg.register_pair(default_cfg, tsrc, ttgt, models,
                                 draws=draws, device="cpu")
    assert torch.equal(tres.pose, default.pose)
    assert torch.equal(tres.num_inliers, default.num_inliers)
