"""Port parity of the multi-frame front end (``pipeline/multiframe.py``):
``build_pose_graph`` and ``register_sequence`` against the JAX functions,
on ``tests/test_multiframe.py``'s configuration (2048 points, 256
keypoints, 128-point patches, one scale, ``snapshot/synthetic``) and its
k = 4 trajectory with the (0, 3) loop closure.

The port is fed JAX's draws, those that ``register_pairs_batched``
derives from ``PRNGKey(0)`` (per batch, per slot). Tolerances: the factors
within 1e-6; with float32 conv stacks on both sides (the pairs then agree
to the bit, measured) every refined pose within 0.02 m and 2 degrees of
JAX's; with the shipped bf16 stacks on both sides (two keys) within 0.05
m and 3 degrees of JAX's and within ``tests/test_multiframe.py``'s
ground-truth thresholds (0.15 m, 10 degrees), frame 0 at the identity;
the port's GN on JAX's factors within 1e-4 of JAX's poses. The edge-by-edge path (``batch_size=1``) with
the batched path's draws gives the batched path's poses (1e-5).
"""

import dataclasses
import importlib.util
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.pipeline import multiframe as jmf
from bufferx_tpu.pipeline import registration as jreg
from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.parallel import posegraph as tpg
from bufferx_tpu_torch.pipeline import multiframe as tmf
from bufferx_tpu_torch.pipeline import registration as treg
from bufferx_tpu_torch.tools.weights import load_snapshot
from test_multiframe import make_trajectory, small_cfg
from test_torch_batched import _batch_draws
from test_torch_pipeline import few_threads  # noqa: F401

SNAP = os.path.join(os.path.dirname(__file__), "..", "snapshot", "synthetic")
SMALL = dict(
    capacity=dict(max_points=2048, num_ransac_hypotheses=1024,
                  ransac_chunk=256, sphere_query_chunk=64),
    patch=dict(num_fps=256, num_points_radius_estimate=256,
               num_points_per_patch=128, num_scales=1,
               search_radius_thresholds=(5.0,)),
)
K = 4
LOOPS = [(0, 3)]


def test_build_pose_graph_matches_jax():
    rs = np.random.RandomState(0)
    edges = [(0, 1), (1, 2), (2, 3), (0, 3)]
    meas = []
    for _ in edges:
        R = np.linalg.qr(rs.randn(3, 3))[0]
        R *= np.sign(np.linalg.det(R))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, rs.randn(3)
        meas.append(T)
    inliers = [100, 2, 5, 37]
    ref = jmf.build_pose_graph(edges, meas, inliers, min_inliers=5)
    got = tmf.build_pose_graph(edges, meas, inliers, min_inliers=5,
                               device="cpu")
    assert got.edges_i.tolist() == np.asarray(ref.edges_i).tolist()
    assert got.edges_j.tolist() == np.asarray(ref.edges_j).tolist()
    np.testing.assert_allclose(got.t_meas.numpy(), np.asarray(ref.t_meas),
                               atol=1e-6)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights),
                               atol=1e-6)
    assert float(got.weights[1]) == 0.0 and float(got.weights[0]) == 10.0
    # tensors on the device are read where they are
    got_t = tmf.build_pose_graph(edges, torch.from_numpy(np.stack(meas)),
                                 torch.tensor(inliers), device="cpu")
    assert torch.equal(got_t.weights, got.weights)


@pytest.fixture(scope="module")
def sequence():
    jcfg = small_cfg()
    tcfg = make_cfg("ModelNet40").override(**SMALL)
    clouds, gt = make_trajectory(np.random.RandomState(0), k=K)
    jparams = {}
    for stage in ("Desc", "Pose"):
        with open(os.path.join(SNAP, stage, "best.msgpack"), "rb") as f:
            jparams[stage.lower()] = jax.tree.map(
                jnp.asarray, flax.serialization.msgpack_restore(f.read()))
    return dict(jcfg=jcfg, tcfg=tcfg, clouds=clouds, gt=gt, jparams=jparams,
                state_dicts=load_snapshot(SNAP))


def _f32_statics(monkeypatch):
    """Both packages' pipelines with float32 conv stacks (``use_bf16`` is a
    statics field that no configuration sets)."""
    for mod in (jreg, treg):
        orig = mod.PipelineStatics.from_config
        monkeypatch.setattr(mod.PipelineStatics, "from_config", classmethod(
            lambda cls, cfg, orig=orig: dataclasses.replace(orig(cfg),
                                                            use_bf16=False)))


def _models(s):
    return treg.build_models(treg.PipelineStatics.from_config(s["tcfg"]),
                             s["state_dicts"], "cpu")


def _gt_ok(poses, gt):
    np.testing.assert_allclose(poses[0].numpy(), np.eye(4), atol=1e-3)
    for i in range(K):
        g = torch.from_numpy(gt[i])
        assert float(se3.compute_rte(poses[i], g)) < 0.15, i
        assert float(se3.compute_rre(poses[i], g)) < 10.0, i


def _run(s, key, **kw):
    """JAX's register_sequence from ``key`` and the port's with the same
    draws (batched path)."""
    ref = jmf.register_sequence(s["jcfg"], s["clouds"], s["jparams"], key,
                                loop_closures=LOOPS, **kw)
    draws = _batch_draws(key, jreg.PipelineStatics.from_config(s["jcfg"]),
                         K - 1 + len(LOOPS), 8)
    out = tmf.register_sequence(s["tcfg"], s["clouds"], _models(s),
                                loop_closures=LOOPS, draws=draws,
                                device="cpu", **kw)
    assert out.poses.shape == (K, 4, 4)
    assert len(out.pair_results) == K - 1 + len(LOOPS)
    return ref, out, draws


def test_register_sequence_matches_jax(sequence, monkeypatch):
    """Float32 conv stacks: the same measurements in both packages, so every
    refined pose within 0.02 m / 2 degrees of JAX's."""
    _f32_statics(monkeypatch)
    ref, out, draws = _run(sequence, jax.random.PRNGKey(0))
    jposes = torch.from_numpy(np.array(ref.poses))
    for i in range(K):
        assert float(se3.compute_rte(out.poses[i], jposes[i])) <= 0.02, i
        assert float(se3.compute_rre(out.poses[i], jposes[i])) <= 2.0, i
    np.testing.assert_allclose(out.graph.weights.numpy(),
                               np.asarray(ref.graph.weights), atol=1e-6)
    _gt_ok(out.poses, sequence["gt"])
    # the port's GN on JAX's factors gives JAX's poses
    graph = tpg.PoseGraph(*(torch.from_numpy(np.array(x)) for x in ref.graph))
    graph = graph._replace(edges_i=graph.edges_i.long(),
                           edges_j=graph.edges_j.long())
    poses = tpg.pose_graph_gauss_newton(
        graph, tpg.chain_initialization(graph, K), num_poses=K, num_iters=10,
        robust="huber", robust_scale=0.3)
    np.testing.assert_allclose(poses.numpy(), np.asarray(ref.poses),
                               atol=1e-4)
    # the edge-by-edge path with each edge's final draws (phase 2, all
    # edges redone at 50 inliers) gives the batched path's poses
    assert all(int(r.scales_used) == 1 and int(r.num_inliers) < 50
               for r in out.pair_results)
    loop = tmf.register_sequence(
        sequence["tcfg"], sequence["clouds"], _models(sequence),
        loop_closures=LOOPS, batch_size=1, device="cpu",
        draws=[type(draws[0][1])(*(x[n] for x in draws[0][1]))
               for n in range(K - 1 + len(LOOPS))])
    torch.testing.assert_close(loop.poses, out.poses, atol=1e-5, rtol=0)


# bf16 against JAX's bf16: each refined pose within about twice the largest
# gap that keys 0 and 1 show on the CPU (0.0238 m on key 0, 1.49 degrees on
# key 1)
BF16_RTE, BF16_RRE = 0.05, 3.0


def _bf16_case(sequence, seed):
    """Both packages with the shipped bf16 conv stacks from ``PRNGKey(seed)``:
    every refined pose within ``BF16_RTE`` / ``BF16_RRE`` of JAX's and
    within the ground-truth thresholds. Prints the largest gaps."""
    ref, out, _ = _run(sequence, jax.random.PRNGKey(seed))
    jposes = torch.from_numpy(np.array(ref.poses))
    rte = max(float(se3.compute_rte(out.poses[i], jposes[i]))
              for i in range(K))
    rre = max(float(se3.compute_rre(out.poses[i], jposes[i]))
              for i in range(K))
    print(f"bf16, key {seed}: largest gap to JAX {rte:.4f} m, {rre:.3f} deg")
    assert rte <= BF16_RTE and rre <= BF16_RRE, (seed, rte, rre)
    _gt_ok(out.poses, sequence["gt"])


def test_register_sequence_bf16(sequence):
    """The shipped bf16 conv stacks on both sides: bf16 rounding moves a few
    mutual matches against the JAX package's (key 0: frame 1 2.4 cm from
    JAX's, over the float32 bound of 0.02 m), so the poses are held to
    JAX's within ``BF16_RTE`` / ``BF16_RRE`` and to the ground truth."""
    _bf16_case(sequence, 0)


def test_register_sequence_bf16_second_key(sequence):
    """The same on a second key, a second witness of the bf16 gap."""
    _bf16_case(sequence, 1)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_exp_multiframe",
        os.path.join(os.path.dirname(__file__), "..", "scripts",
                     "exp_multiframe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exp_multiframe_frames_match_the_jax_script():
    """``tools/exp_multiframe.py`` builds ``scripts/exp_multiframe.py``'s
    trajectory and frame clouds bit for bit (the port's hardsynth copy),
    with its flags' defaults, and its ATE."""
    from bufferx_tpu.data.hardsynth import eval_scene as jax_eval_scene
    from bufferx_tpu_torch.data.hardsynth import eval_scene
    from bufferx_tpu_torch.tools import exp_multiframe as tool

    script = _jax_script()
    args = tool.parse_args([])
    assert (args.frames, args.num_points, args.extent, args.radius,
            args.view_radius, args.noise, args.loop_every, args.gn_iters,
            args.seed, args.checkpoint_dir, args.device) == (
        50, 4096, 6.0, 1.6, 3.5, 0.005, 10, 15, 42,
        "snapshot/hard_moments_r4ft2", "cuda")
    rs_j, rs_t = np.random.RandomState(42), np.random.RandomState(42)
    prims_j, prims_t = jax_eval_scene(rs_j, 6.0), eval_scene(rs_t, 6.0)
    traj_j = script.make_trajectory(6, 1.6, rs_j)
    traj_t = tool.make_trajectory(6, 1.6, rs_t)
    np.testing.assert_array_equal(np.stack(traj_j), np.stack(traj_t))
    for T in traj_t[:3]:
        np.testing.assert_array_equal(
            script.frame_cloud(prims_j, T, rs_j, 2048, 3.5, 0.005),
            tool.frame_cloud(prims_t, T, rs_t, 2048, 3.5, 0.005))
    est = [T @ np.diag([1.0, 1.0, 1.0, 1.0]) + 0.01 * i
           for i, T in enumerate(traj_t)]
    assert script.ate(est, traj_j) == tool.ate(est, traj_t)
