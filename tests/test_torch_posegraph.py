"""Port parity of the pose-graph layer (``parallel/posegraph.py``) and the
SE(3) helpers it needs: the same numpy graphs through the JAX functions and
the port's, float32 on both sides.

Tolerances: the SE(3) helpers within 1e-6; the normal equations within
1e-5 of their largest entry (the JAX package sums the dense ``jacfwd``
Jacobian, the port two analytic [12, 6] blocks a factor); Gauss-Newton
poses within 1e-4 of JAX's after 10 iterations (15 for the robust case),
on ``tests/test_parallel.py``'s ring graphs and ``tests/test_bundle.py``'s
bad-loop-closure graph.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.core import se3 as jse3
from bufferx_tpu.parallel import posegraph as jpg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.parallel import posegraph as tpg
from test_bundle import make_scene
from test_parallel import make_ring_graph

GN_TOL = 1e-4


def to_port(graph) -> tpg.PoseGraph:
    return tpg.PoseGraph(
        torch.from_numpy(np.asarray(graph.edges_i, np.int64)),
        torch.from_numpy(np.asarray(graph.edges_j, np.int64)),
        torch.from_numpy(np.array(graph.t_meas, np.float32)),
        torch.from_numpy(np.array(graph.weights, np.float32)))


def bad_closure_graph():
    """``tests/test_bundle.py``'s 5-frame chain with a corrupted (0, 4)
    loop closure, from identity poses."""
    rs = np.random.RandomState(5)
    poses_gt, _, _ = make_scene(rs, k=5, n_lms=3)
    edges = [(i, i + 1) for i in range(4)] + [(0, 4)]
    meas = [np.linalg.inv(np.asarray(poses_gt[i])) @ np.asarray(poses_gt[j])
            for i, j in edges]
    meas[-1][:3, 3] += np.array([1.5, -1.0, 0.5], np.float32)
    graph = jpg.PoseGraph(
        jnp.asarray([e[0] for e in edges], jnp.int32),
        jnp.asarray([e[1] for e in edges], jnp.int32),
        jnp.asarray(np.stack(meas), jnp.float32),
        jnp.ones(len(edges), jnp.float32))
    init = jnp.asarray(np.stack([np.eye(4, dtype=np.float32)] * 5))
    return graph, init, np.asarray(poses_gt)


def _close(ref, got, tol):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    err = float(np.abs(ref - got).max())
    assert err <= tol, err


# ---- SE(3) helpers ----------------------------------------------------------
@pytest.mark.parametrize("scale", [0.0, 1e-5, 0.3, 3.0])
def test_axis_angle_to_rotation_matches_jax(scale):
    rs = np.random.RandomState(0)
    w = (rs.randn(16, 3) * scale).astype(np.float32)
    ref = jse3.axis_angle_to_rotation(jnp.asarray(w))
    got = se3.axis_angle_to_rotation(torch.from_numpy(w))
    _close(ref, got, 1e-6)
    eye = torch.eye(3).expand(16, 3, 3)
    _close(eye, got @ got.transpose(1, 2), 1e-5)


def test_inverse_and_concatenate_match_jax():
    rs = np.random.RandomState(1)
    R = se3.axis_angle_to_rotation(torch.from_numpy(
        rs.randn(8, 3).astype(np.float32)))
    T = se3.integrate(R, torch.from_numpy(rs.randn(8, 3).astype(np.float32)))
    Tn = T.numpy()
    _close(jse3.inverse(jnp.asarray(Tn)), se3.inverse(T), 1e-6)
    _close(jse3.concatenate(jnp.asarray(Tn), jnp.asarray(Tn[::-1].copy())),
           se3.concatenate(T, T.flip(0)), 1e-5)
    _close(np.broadcast_to(np.eye(4), (8, 4, 4)),
           se3.concatenate(T, se3.inverse(T)), 1e-5)


# ---- the graph --------------------------------------------------------------
def test_chain_initialization_matches_jax():
    graph, _ = make_ring_graph(np.random.RandomState(1), k=8, noise_rot=0.05,
                               noise_tr=0.05)
    _close(jpg.chain_initialization(graph, 8),
           tpg.chain_initialization(to_port(graph), 8), 1e-6)


@pytest.mark.parametrize("robust", ["none", "huber", "gm"])
def test_normal_equations_match_jax(robust):
    graph, _ = make_ring_graph(np.random.RandomState(3), k=6, noise_rot=0.05,
                               noise_tr=0.05)
    init = jpg.chain_initialization(graph, 6)
    tgraph, tinit = to_port(graph), torch.from_numpy(np.array(init))
    if robust != "none":
        w = jpg._robust_factor_weights(init, graph, robust, 0.05)
        tw = tpg._robust_factor_weights(tinit, tgraph, robust, 0.05)
        _close(w, tw, 1e-6)
        graph = graph._replace(weights=w)
        tgraph = tgraph._replace(weights=tw)
    JTJ, JTr = jpg._accumulate_normal_eqs(jnp.zeros((6, 6)), init, graph, 6)
    tJTJ, tJTr = tpg._accumulate_normal_eqs(tinit, tgraph, 6)
    scale = float(np.abs(np.asarray(JTJ)).max())
    _close(JTJ, tJTJ, 1e-5 * scale)
    _close(JTr, tJTr, 1e-5 * max(1.0, float(np.abs(np.asarray(JTr)).max())))


def test_factor_jacobians_match_finite_differences():
    """The analytic blocks against central differences of the port's own
    residual in float64, at a random pose set."""
    graph, _ = make_ring_graph(np.random.RandomState(4), k=5, noise_rot=0.1,
                               noise_tr=0.1)
    g = to_port(graph)
    g = tpg.PoseGraph(g.edges_i, g.edges_j, g.t_meas.double(),
                      g.weights.double() * 1.5)
    poses = tpg.chain_initialization(g, 5)
    J_i, J_j = tpg._factor_jacobians(poses, g)
    eps = 1e-6
    for frame in range(5):
        for d in range(6):
            delta = torch.zeros(5, 6, dtype=torch.float64)
            delta[frame, d] = eps
            hi = tpg._factor_residual(tpg._apply_increment(poses, delta), g)
            lo = tpg._factor_residual(tpg._apply_increment(poses, -delta), g)
            fd = (hi - lo) / (2 * eps)
            want = (torch.where((g.edges_i == frame)[:, None], J_i[:, :, d], 0)
                    + torch.where((g.edges_j == frame)[:, None], J_j[:, :, d],
                                  0))
            assert float((fd - want).abs().max()) < 1e-7, (frame, d)


CASES = {
    "exact_k6": dict(seed=0, k=6, noise=0.0),
    "noisy_k8": dict(seed=1, k=8, noise=0.05),
    "noisy_k8_huber": dict(seed=1, k=8, noise=0.05, robust="huber",
                           robust_scale=0.05),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gauss_newton_matches_jax(case):
    c = dict(CASES[case])
    graph, gt = make_ring_graph(np.random.RandomState(c.pop("seed")),
                                k=c["k"], noise_rot=c["noise"],
                                noise_tr=c.pop("noise"))
    k = c.pop("k")
    init = jpg.chain_initialization(graph, k)
    ref = jpg.pose_graph_gauss_newton(graph, init, num_poses=k, num_iters=10,
                                      **c)
    got = tpg.pose_graph_gauss_newton(
        to_port(graph), torch.from_numpy(np.array(init)), num_poses=k,
        num_iters=10, **c)
    _close(ref, got, GN_TOL)
    if case == "exact_k6":
        for i in range(k):
            assert float(se3.compute_rte(got[i], torch.from_numpy(gt[i]))) < 1e-3


def test_gauss_newton_huber_bad_loop_closure_matches_jax():
    graph, init, gt = bad_closure_graph()
    kw = dict(num_poses=5, num_iters=15, robust="huber", robust_scale=0.02)
    ref = jpg.pose_graph_gauss_newton(graph, init, **kw)
    got = tpg.pose_graph_gauss_newton(to_port(graph),
                                      torch.from_numpy(np.array(init)), **kw)
    _close(ref, got, GN_TOL)
    err = sum(float(se3.compute_rte(got[i], torch.tensor(gt[i])))
              for i in range(5))
    assert err < 0.05


def test_zero_weight_factor_is_ignored():
    graph, gt = make_ring_graph(np.random.RandomState(2), k=5, noise_rot=0.0,
                                noise_tr=0.0)
    g = to_port(graph)
    bad = torch.eye(4)
    bad[:3, 3] = 100.0
    g = tpg.PoseGraph(torch.cat([g.edges_i, torch.tensor([0])]),
                      torch.cat([g.edges_j, torch.tensor([3])]),
                      torch.cat([g.t_meas, bad[None]]),
                      torch.cat([g.weights, torch.tensor([0.0])]))
    out = tpg.pose_graph_gauss_newton(g, tpg.chain_initialization(g, 5),
                                      num_poses=5, num_iters=5)
    for i in range(5):
        assert float(se3.compute_rte(out[i], torch.from_numpy(gt[i]))) < 1e-3


def test_robust_none_raises_in_both_packages():
    """``robust=None`` is not "no reweighting": the pose graph tests
    ``robust != "none"`` and the robust weight refuses None, in the JAX
    package and in the port alike."""
    graph, init, _ = bad_closure_graph()
    with pytest.raises(ValueError, match="unknown robust kernel"):
        jpg.pose_graph_gauss_newton(graph, init, num_poses=5, num_iters=1,
                                    robust=None)
    with pytest.raises(ValueError, match="unknown robust kernel"):
        tpg.pose_graph_gauss_newton(to_port(graph),
                                    torch.from_numpy(np.array(init)),
                                    num_poses=5, num_iters=1, robust=None)


def test_float64_on_the_cpu_runs_in_float64():
    graph, _ = make_ring_graph(np.random.RandomState(1), k=8, noise_rot=0.05,
                               noise_tr=0.05)
    g = to_port(graph)
    g = g._replace(t_meas=g.t_meas.double(), weights=g.weights.double())
    init = tpg.chain_initialization(g, 8)
    assert init.dtype == torch.float64
    out = tpg.pose_graph_gauss_newton(g, init, num_poses=8, num_iters=10)
    out32 = tpg.pose_graph_gauss_newton(to_port(graph), init.float(),
                                        num_poses=8, num_iters=10)
    assert out.dtype == torch.float64
    assert float((out - out32.double()).abs().max()) < GN_TOL
