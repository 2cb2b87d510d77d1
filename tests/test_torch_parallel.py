"""Port parity of the distributed layer (``parallel/{mesh,sharded}.py``,
the sharded normal equations, the cross-rank BatchNorm, the sequence's
sharded branch and ``tools/dryrun.py``): two gloo ranks started by
``parallel.spawn`` (``tests/torch_dist_worker.py``), each held against the
JAX package on a 2-device virtual mesh and against the port on one rank.

Tolerances: the factor-sharded GN and the observation-sharded BA within
1e-5 of the port's unsharded result and 1e-4 of JAX's sharded one; the
pair-sharded evaluation at world size 2 (3 pairs: a ragged tail) equal to
world size 1 (poses 1e-5, counts equal), and, with JAX's draws and float32
conv stacks on both sides, poses within 0.02 m / 2 degrees of JAX's
``make_sharded_eval``; the data-parallel Desc step (2 samples a rank, so
each sample's BatchNorm statistics are averaged with the other rank's
sample at the same position, as JAX's ``pmean`` under ``vmap`` does) with
its loss and metrics within 1e-4 of JAX's ``make_sharded_train_step``, the
new running statistics within 1e-4 of their largest magnitude, and the
parameters' change within ``tests/test_torch_trainer.py``'s 1e-1 relative
L2 (Adam's first step moves an element by the sign of its gradient, and
train-mode BatchNorm's float32 gradient noise flips some small ones). At
the dry run's tiny shapes (``__graft_entry__.py``'s).
"""

import dataclasses
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_worker
from bufferx_tpu.config import make_cfg as jax_make_cfg
from bufferx_tpu.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu.data.training import build_training_batch as jax_build_batch
from bufferx_tpu.parallel import bundle as jba
from bufferx_tpu.parallel import make_mesh as jax_make_mesh
from bufferx_tpu.parallel import make_sharded_eval as jax_sharded_eval
from bufferx_tpu.parallel import make_sharded_train_step as jax_sharded_train
from bufferx_tpu.parallel import posegraph as jpg
from bufferx_tpu.pipeline import registration as jreg
from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.models.layers import ConvBNRelu
from bufferx_tpu_torch.parallel import bundle as tba
from bufferx_tpu_torch.parallel import mesh as tmesh
from bufferx_tpu_torch.parallel import posegraph as tpg
from bufferx_tpu_torch.parallel.sharded import make_sharded_eval
from bufferx_tpu_torch.pipeline import multiframe as tmf
from bufferx_tpu_torch.pipeline import registration as treg
from bufferx_tpu_torch.tools import dryrun
from bufferx_tpu_torch.tools.weights import (
    DESC_MODULES,
    load_snapshot,
    params_from_numpy,
)
from test_bundle import make_scene, perturb
from test_multiframe import make_trajectory
from test_parallel import make_ring_graph
from test_torch_pipeline import _jax_draws, few_threads  # noqa: F401
from test_torch_train_forward import jax_draws

ROOT = os.path.join(os.path.dirname(__file__), "..")
SNAP = os.path.join(ROOT, "snapshot", "hard_moments_r4ft2")
TINY = dict(
    capacity=dict(max_points=512, num_ransac_hypotheses=128, ransac_chunk=64,
                  sphere_query_chunk=16),
    patch=dict(num_fps=48, num_points_radius_estimate=64,
               num_points_per_patch=32, num_scales=1,
               search_radius_thresholds=(5.0,), desc_mode="moments"),
    train=dict(pos_num=16),
)
WORLD = 2


def _pad(arrays, pad, fill):
    return [np.concatenate([a, np.broadcast_to(np.asarray(f, a.dtype),
                                               (pad,) + a.shape[1:])])
            for a, f in zip(arrays, fill)]


def _restore(stage):
    with open(os.path.join(SNAP, stage, "best.msgpack"), "rb") as f:
        return jax.tree.map(jnp.asarray,
                            flax.serialization.msgpack_restore(f.read()))


def _gn_case():
    graph, _ = make_ring_graph(np.random.RandomState(3), k=6, noise_rot=0.03,
                               noise_tr=0.03)
    e = len(np.asarray(graph.weights))
    ei, ej, tm, w = _pad(
        [np.asarray(graph.edges_i), np.asarray(graph.edges_j),
         np.asarray(graph.t_meas), np.asarray(graph.weights)],
        (-e) % WORLD, [0, 0, np.eye(4, dtype=np.float32), 0.0])
    init = np.array(jpg.chain_initialization(graph, 6))
    kw = dict(num_poses=6, num_iters=8, robust="huber", robust_scale=0.05)
    jgraph = jpg.PoseGraph(jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(tm),
                           jnp.asarray(w))
    ref = jpg.pose_graph_gauss_newton(
        jgraph, jnp.asarray(init), mesh=jax_make_mesh(WORLD, axis_name="fp"),
        axis="fp", **kw)
    tgraph = tpg.PoseGraph(torch.from_numpy(ei.astype(np.int64)),
                           torch.from_numpy(ej.astype(np.int64)),
                           torch.from_numpy(tm.copy()), torch.from_numpy(w))
    single = tpg.pose_graph_gauss_newton(tgraph, torch.from_numpy(init), **kw)
    payload = dict(ei=ei.astype(np.int64), ej=ej.astype(np.int64), tm=tm,
                   w=w, init=init, k=6, iters=8, robust="huber",
                   robust_scale=0.05)
    return payload, np.asarray(ref), single.numpy()


def _ba_case():
    rs = np.random.RandomState(4)
    poses_gt, lms_gt, obs = make_scene(rs, k=4, n_lms=32, noise=0.002)
    poses0, lms0 = perturb(poses_gt, lms_gt, rs)
    edges = [(0, 1), (1, 2), (2, 3)]
    rel = np.stack([np.linalg.inv(np.asarray(poses_gt[i]))
                    @ np.asarray(poses_gt[j]) for i, j in edges])
    pg = _pad([np.asarray([e[0] for e in edges]),
               np.asarray([e[1] for e in edges]), rel.astype(np.float32),
               np.ones(3, np.float32)], 1,
              [0, 0, np.eye(4, dtype=np.float32), 0.0])
    kw = dict(num_poses=4, num_lms=32, num_iters=5)
    jpgraph = jpg.PoseGraph(*(jnp.asarray(a) for a in pg))
    ref = jba.bundle_adjust(poses0, lms0, obs, pose_graph=jpgraph,
                            mesh=jax_make_mesh(WORLD, axis_name="fp"),
                            axis="fp", **kw)
    obs_np = [np.asarray(obs.obs_frame, np.int64),
              np.asarray(obs.obs_lm, np.int64), np.array(obs.obs_local),
              np.array(obs.weights)]
    pg_np = [pg[0].astype(np.int64), pg[1].astype(np.int64),
             np.ascontiguousarray(pg[2]), np.ascontiguousarray(pg[3])]
    single = tba.bundle_adjust(
        torch.from_numpy(np.array(poses0)), torch.from_numpy(np.array(lms0)),
        tba.LandmarkGraph(*(torch.from_numpy(a) for a in obs_np)),
        pose_graph=tpg.PoseGraph(*(torch.from_numpy(a) for a in pg_np)), **kw)
    payload = dict(of=obs_np[0], ol=obs_np[1], oz=obs_np[2], w=obs_np[3],
                   pg_ei=pg_np[0], pg_ej=pg_np[1], pg_tm=pg_np[2],
                   pg_w=pg_np[3], poses0=np.array(poses0),
                   lms0=np.array(lms0), k=4, l=32, iters=5)
    return payload, [np.asarray(x) for x in ref], [x.numpy() for x in single]


def _draws_np(keys, jstatics):
    d = treg.stack_draws([_jax_draws(k, jstatics, num_scales=1)[1]
                          for k in keys])
    return {f: getattr(d, f).numpy() for f in treg.Draws._fields}


@pytest.fixture(scope="module")
def world():
    jcfg = jax_make_cfg("ModelNet40").override(**TINY)
    tcfg = make_cfg("ModelNet40").override(**TINY)
    jstatics = jreg.PipelineStatics.from_config(jcfg)
    jparams = {"desc": _restore("Desc"), "pose": _restore("Pose")}
    gn, gn_ref, gn_single = _gn_case()
    ba, ba_ref, ba_single = _ba_case()

    # 3 pairs: a ragged tail over 2 ranks; JAX's draws, float32 stacks
    srcs, tgts = [], []
    for i in range(3):
        s, t, _ = synthetic_pair_full_overlap(np.random.RandomState(100 + i),
                                              num_points=700)
        srcs.append(jreg.prepare_cloud(s, jcfg, seed=i))
        tgts.append(jreg.prepare_cloud(t, jcfg, seed=i))
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    f32 = dataclasses.replace(jstatics, use_bf16=False)
    jeval = jax_sharded_eval(jparams, f32, jax_make_mesh(WORLD))(
        jax.tree.map(lambda *x: jnp.stack(x), *srcs),
        jax.tree.map(lambda *x: jnp.stack(x), *tgts), jnp.zeros(3, bool),
        keys)
    ev = dict(srcs=[(np.array(c.xyz), np.array(c.mask)) for c in srcs],
              tgts=[(np.array(c.xyz), np.array(c.mask)) for c in tgts],
              draws=_draws_np(keys, jstatics))

    # a 3-frame sequence through the sharded branch
    clouds, _ = make_trajectory(np.random.RandomState(1), k=3)
    seq = dict(clouds=clouds, draws=_draws_np(
        jax.random.split(jax.random.PRNGKey(2), 2), jstatics))

    # the data-parallel Desc step: 4 samples, 2 a rank
    batches = []
    for i in range(4):
        rs = np.random.RandomState(i)
        s, t, T = synthetic_pair_full_overlap(rs, num_points=700)
        batches.append(jax_build_batch(jcfg, s, t, T, rs, None,
                                       host_arrays=True))
    tkeys = jax.random.split(jax.random.PRNGKey(0), 4)
    opt = optax.adam(1e-3)
    variables = _restore("Desc")
    new_vars, _, jmetrics = jax_sharded_train(jcfg, jax_make_mesh(WORLD),
                                              opt)(
        variables, opt.init(variables["params"]),
        jax.tree.map(lambda *x: jnp.stack([jnp.asarray(v) for v in x]),
                     *batches), tkeys)
    train = dict(batches=batches, lr=1e-3, draws=[
        tuple(x.numpy() for x in jax_draws(k, jcfg.train.pos_num,
                                           jcfg.capacity.max_points))
        for k in tkeys])

    payload = dict(cfg=TINY, snapshot=SNAP, gn=gn, ba=ba, eval=ev,
                   sequence=seq, train=train)
    ranks = tmesh.spawn(torch_dist_worker.checks, WORLD, "cpu",
                        args=(payload,))

    # the port on one rank (no process group), float32 stacks
    with pytest.MonkeyPatch.context() as mp:
        orig = treg.PipelineStatics.from_config
        mp.setattr(treg.PipelineStatics, "from_config", classmethod(
            lambda cls, cfg: dataclasses.replace(orig(cfg), use_bf16=False)))
        models = treg.build_models(treg.PipelineStatics.from_config(tcfg),
                                   load_snapshot(SNAP), "cpu")
        one = tmesh.make_mesh(device="cpu")
        eval1 = make_sharded_eval(models, tcfg, one)

        def clouds_of(pairs):
            return [treg.Cloud(torch.from_numpy(x), torch.from_numpy(m))
                    for x, m in pairs]

        res1 = eval1(clouds_of(ev["srcs"]), clouds_of(ev["tgts"]),
                     draws=torch_dist_worker.draws_of(ev["draws"]),
                     is_aligned=False)
        prep = [treg.prepare_cloud(c, tcfg, seed=i, device="cpu")
                for i, c in enumerate(clouds)]
        seq1 = eval1([prep[0], prep[1]], [prep[1], prep[2]],
                     draws=torch_dist_worker.draws_of(seq["draws"]),
                     is_aligned=False)
    return dict(ranks=ranks, gn_ref=gn_ref, gn_single=gn_single,
                ba_ref=ba_ref, ba_single=ba_single, jeval=jeval, eval1=res1,
                seq1=seq1, jvars=new_vars, jmetrics=jmetrics,
                p0=load_snapshot(SNAP)["desc"])


def test_mesh_ranks_and_refusals(world):
    for r, out in enumerate(world["ranks"]):
        assert (out["rank"], out["world_size"], out["device"]) == (r, 2, "cpu")
        assert out["too_many_raises"] and out["too_few_raises"]
        assert out["whole"] == (r, 2)
    one = tmesh.make_mesh(device="cpu")
    assert (one.group, one.rank, one.world_size) == (None, 0, 1)
    x = torch.arange(3.0)
    assert one.all_reduce(x) is x and one.all_gather(x) is x
    with pytest.raises(ValueError):
        tmesh.make_mesh(2, device="cpu")


def test_no_card_no_fallback():
    """A CUDA mesh or CUDA ranks without a card raise: nothing drops to the
    CPU or to gloo on its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        tmesh.make_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        tmesh.spawn(torch_dist_worker.checks, 1, "cuda")


def test_factor_sharded_gauss_newton(world):
    for out in world["ranks"]:
        np.testing.assert_allclose(out["gn"], world["gn_single"], atol=1e-5)
        np.testing.assert_allclose(out["gn"], world["gn_ref"], atol=1e-4)


def test_observation_sharded_bundle_adjust(world):
    for out in world["ranks"]:
        for got, single, ref in zip(out["ba"], world["ba_single"],
                                    world["ba_ref"]):
            np.testing.assert_allclose(got, single, atol=1e-5)
            np.testing.assert_allclose(got, ref, atol=1e-4)


def test_pair_sharded_eval_ragged_tail(world):
    one = world["eval1"]
    jev = world["jeval"]
    assert one.pose.shape == (3, 4, 4)
    for out in world["ranks"]:
        ev = out["eval"]
        assert ev["pose"].shape == (3, 4, 4)
        np.testing.assert_allclose(ev["pose"], one.pose.numpy(), atol=1e-5)
        for f in ("num_inliers", "num_mutual", "num_consensus",
                  "scales_used", "valid"):
            np.testing.assert_array_equal(ev[f], getattr(one, f).numpy())
        np.testing.assert_array_equal(ev["valid"], np.asarray(jev.valid))
        for i in range(3):
            got = torch.from_numpy(ev["pose"][i])
            ref = torch.from_numpy(np.array(jev.pose[i]))
            assert float(se3.compute_rte(got, ref)) <= 0.02, i
            assert float(se3.compute_rre(got, ref)) <= 2.0, i


def test_sequence_sharded_branch(world):
    """``register_sequence(use_mesh=True)`` over 2 ranks: its edges are the
    one-rank sharded eval's, and its poses the GN of their factors."""
    one = world["seq1"]
    graph = tmf.build_pose_graph([(0, 1), (1, 2)], one.pose, one.num_inliers,
                                 device="cpu")
    poses = tpg.pose_graph_gauss_newton(
        graph, tpg.chain_initialization(graph, 3), num_poses=3, num_iters=5,
        robust="huber", robust_scale=0.3)
    for out in world["ranks"]:
        seq = out["sequence"]
        np.testing.assert_allclose(seq["pairs"], one.pose.numpy(), atol=1e-5)
        np.testing.assert_allclose(seq["poses"], poses.numpy(), atol=1e-5)


def _rel_l2(ref, got, keys, base):
    num = sum(float(np.sum((ref[k] - got[k]) ** 2)) for k in keys)
    den = sum(float(np.sum((ref[k] - base[k]) ** 2)) for k in keys)
    return (num / max(den, 1e-30)) ** 0.5


def test_data_parallel_train_step(world):
    jm = {k: float(v) for k, v in world["jmetrics"].items()}
    want = {k: np.asarray(v) for k, v in params_from_numpy(
        jax.tree.map(np.asarray, world["jvars"]), DESC_MODULES).items()}
    p0 = {k: v.numpy() for k, v in world["p0"].items()}
    got0 = world["ranks"][0]["train"]
    for out in world["ranks"]:
        t = out["train"]
        assert set(t["metrics"]) == set(jm)
        for k, v in jm.items():
            assert abs(t["metrics"][k] - v) <= 1e-4 * max(1.0, abs(v)), k
        for k, v in t["state"].items():     # replicated on every rank
            np.testing.assert_array_equal(v, got0["state"][k])
    got = got0["state"]
    stats = [k for k in want if k.endswith(("bn_mean", "bn_var"))]
    assert stats
    for k in stats:
        scale = max(1.0, float(np.abs(want[k]).max()))
        assert float(np.abs(want[k] - got[k]).max()) <= 1e-4 * scale, k
    dead = {f"{n}.bias" for n, m in _desc_modules() if m.use_bn}
    live = [k for k in want if k not in stats and k not in dead]
    assert _rel_l2(want, got, live, p0) <= 1e-1


def _desc_modules():
    from bufferx_tpu_torch.train.trainer import train_models

    desc, _ = train_models(make_cfg("ModelNet40").override(**TINY),
                           load_snapshot(SNAP), "cpu")
    return [(n, m) for n, m in desc.named_modules()
            if isinstance(m, ConvBNRelu)]


def test_dryrun_multichip_on_gloo_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out = dryrun.dryrun_multichip(2, device="cpu")
    assert [o["backend"] for o in out] == ["gloo", "gloo"]
    for o in out:
        assert np.isfinite(o["loss"]) and o["pose"].shape == (2, 4, 4)
        assert bool(torch.isfinite(o["gn"]).all())
        torch.testing.assert_close(o["gn"], out[0]["gn"], atol=0, rtol=0)
        torch.testing.assert_close(o["pose"], out[0]["pose"], atol=0, rtol=0)
    fn, args = dryrun.entry(device="cpu")
    res = fn(*args)
    assert res.pose.shape == (4, 4) and bool(torch.isfinite(res.pose).all())
