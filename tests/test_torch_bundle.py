"""Port parity of bundle adjustment (``parallel/bundle.py``): the robust
weights, the analytic observation Jacobians, the arrowhead blocks (a
scatter with repeated (frame, landmark) pairs among them) and the whole
Gauss-Newton with the Schur complement, with and without pose-graph
factors, on ``tests/test_bundle.py``'s scenes, float32 on both sides.

Tolerances: weights, residuals and Jacobian blocks within 1e-6; the
arrowhead blocks within 1e-5 of their largest entry; poses and landmarks
within 1e-4 of JAX's after 8 iterations. The Jacobians also against
central differences of the port's residual in float64 (1e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.parallel import bundle as jba
from bufferx_tpu.parallel import posegraph as jpg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.parallel import bundle as tba
from bufferx_tpu_torch.parallel import posegraph as tpg
from test_bundle import make_scene, perturb
from test_torch_posegraph import _close, to_port

BA_TOL = 1e-4


def obs_to_port(obs) -> tba.LandmarkGraph:
    return tba.LandmarkGraph(
        torch.from_numpy(np.asarray(obs.obs_frame, np.int64)),
        torch.from_numpy(np.asarray(obs.obs_lm, np.int64)),
        torch.from_numpy(np.array(obs.obs_local, np.float32)),
        torch.from_numpy(np.array(obs.weights, np.float32)))


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind", ["none", "huber", "gm"])
def test_robust_weight_matches_jax(kind):
    r = np.concatenate([[0.0, 1e-13, 0.05, 0.5, 10.0],
                        np.random.RandomState(0).rand(32) * 3]).astype(
                            np.float32)
    _close(jba.robust_weight(jnp.asarray(r), kind, 0.3),
           tba.robust_weight(torch.from_numpy(r), kind, 0.3), 1e-6)


def test_robust_weight_refuses_unknown_kernels():
    r = torch.ones(3)
    for kind in (None, "cauchy"):
        with pytest.raises(ValueError, match="unknown robust kernel"):
            tba.robust_weight(r, kind, 1.0)
        with pytest.raises(ValueError, match="unknown robust kernel"):
            jba.robust_weight(jnp.ones(3), kind, 1.0)


@pytest.mark.parametrize("robust", ["none", "gm"])
def test_obs_blocks_match_jax(robust):
    rs = np.random.RandomState(0)
    poses, lms, obs = make_scene(rs, k=3, n_lms=12, noise=0.01)
    poses, lms = perturb(poses, lms, rs)
    ref = jba._obs_blocks(poses, lms, obs, robust, 0.05)
    got = tba._obs_blocks(t(poses), t(lms), obs_to_port(obs), robust, 0.05)
    for a, b in zip(ref, got):
        _close(a, b, 1e-6)


def test_obs_jacobians_match_finite_differences():
    rs = np.random.RandomState(0)
    poses, lms, obs = make_scene(rs, k=2, n_lms=3)
    poses, lms = perturb(poses, lms, rs)
    poses, lms = t(poses).double(), t(lms).double()
    g = obs_to_port(obs)
    g = g._replace(obs_local=g.obs_local.double(), weights=g.weights.double())
    r, Jp, Jl, _ = tba._obs_blocks(poses, lms, g, "none", 1.0)
    eps = 1e-6
    for d in range(3):
        step = torch.zeros_like(lms)
        step[:, d] = eps
        fd = (tba._obs_blocks(poses, lms + step, g, "none", 1.0)[0]
              - tba._obs_blocks(poses, lms - step, g, "none", 1.0)[0]) / (2 * eps)
        assert float((fd - Jl[:, :, d]).abs().max()) < 1e-7
    for d in range(6):
        delta = torch.zeros(2, 6, dtype=torch.float64)
        delta[1, d] = eps
        fd = (tba._obs_blocks(tpg._apply_increment(poses, delta), lms, g,
                              "none", 1.0)[0]
              - tba._obs_blocks(tpg._apply_increment(poses, -delta), lms, g,
                                "none", 1.0)[0]) / (2 * eps)
        mask = g.obs_frame == 1
        assert float((fd[mask] - Jp[mask, :, d]).abs().max()) < 1e-7


def test_arrowhead_scatter_with_repeated_pairs_matches_jax():
    """Observations that share a frame and a landmark add up in ``B`` (the
    JAX ``B.at[frame, :, lm, :].add``), as do repeated frames in ``A`` and
    landmarks in ``C``."""
    rs = np.random.RandomState(6)
    poses, lms, obs = make_scene(rs, k=3, n_lms=5, noise=0.01)
    pick = rs.randint(0, len(np.asarray(obs.weights)), 40)
    obs = jba.LandmarkGraph(obs.obs_frame[pick], obs.obs_lm[pick],
                            obs.obs_local[pick] + 0.01,
                            jnp.asarray(rs.rand(40).astype(np.float32)))
    pairs = set(zip(np.asarray(obs.obs_frame).tolist(),
                    np.asarray(obs.obs_lm).tolist()))
    assert len(pairs) < 40      # some (frame, landmark) pairs repeat
    ref = jba._accumulate_arrowhead(poses, lms, obs, 3, 5, "huber", 0.02)
    got = tba._accumulate_arrowhead(t(poses), t(lms), obs_to_port(obs), 3, 5,
                                    "huber", 0.02)
    for a, b in zip(ref, got):
        scale = max(1.0, float(np.abs(np.asarray(a)).max()))
        _close(a, b, 1e-5 * scale)


def _pose_graph(poses_gt, edges):
    rel = [np.linalg.inv(np.asarray(poses_gt[i])) @ np.asarray(poses_gt[j])
           for i, j in edges]
    return jpg.PoseGraph(jnp.asarray([e[0] for e in edges], jnp.int32),
                         jnp.asarray([e[1] for e in edges], jnp.int32),
                         jnp.asarray(np.stack(rel), jnp.float32),
                         jnp.ones(len(edges), jnp.float32))


CASES = {
    "plain": dict(seed=1, k=4, n=40, noise=0.0, kw={}),
    "pose_graph": dict(seed=2, k=3, n=25, noise=0.002, pg=[(0, 1), (1, 2)],
                       kw={}),
    "gm_outliers": dict(seed=3, k=3, n=30, noise=0.001, outliers=True,
                        kw=dict(robust="gm", robust_scale=0.05)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_adjust_matches_jax(case):
    c = CASES[case]
    rs = np.random.RandomState(c["seed"])
    poses_gt, lms_gt, obs = make_scene(rs, k=c["k"], n_lms=c["n"],
                                       noise=c["noise"])
    if c.get("outliers"):
        oz = np.asarray(obs.obs_local).copy()
        bad = rs.choice(len(oz), len(oz) // 10, replace=False)
        oz[bad] += rs.uniform(1.0, 2.0, (len(bad), 3))
        obs = obs._replace(obs_local=jnp.asarray(oz))
    poses0, lms0 = perturb(poses_gt, lms_gt, rs)
    pg = _pose_graph(poses_gt, c["pg"]) if "pg" in c else None
    kw = dict(num_poses=c["k"], num_lms=c["n"], num_iters=8, **c["kw"])
    p_ref, l_ref = jba.bundle_adjust(poses0, lms0, obs, pose_graph=pg, **kw)
    p_got, l_got = tba.bundle_adjust(
        t(poses0), t(lms0), obs_to_port(obs),
        pose_graph=None if pg is None else to_port(pg), **kw)
    _close(p_ref, p_got, BA_TOL)
    _close(l_ref, l_got, BA_TOL)
    gt = t(poses_gt)
    rte = max(float(se3.compute_rte(p_got[i], gt[i])) for i in range(c["k"]))
    assert rte < 0.01
