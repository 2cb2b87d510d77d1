"""Multi-frame pose-graph optimization, with the factors sharded over ranks.

Counterpart of :mod:`bufferx_tpu.parallel.posegraph`. Pairwise
registrations become relative-pose factors of a graph over frames, and
Gauss-Newton refines all poses jointly:

- chordal residuals (rotation-matrix difference and translation) under
  axis-angle left-perturbation increments, re-applied after each step;
- each factor's Jacobian is analytic: it couples two frames, so it is two
  [12, 6] blocks (the JAX package takes ``jacfwd`` over all 6K increments at
  the zero increment; the derivative is the same). The blocks are summed
  into the dense normal equations ``J^T J`` [6K, 6K] and ``J^T r`` [6K] by
  one ``index_add_`` each; with a :class:`~bufferx_tpu_torch.parallel.mesh.
  Mesh` every rank sums its own factors and the sums are all-reduced, then
  every rank solves the same system;
- the gauge is fixed by a strong prior on frame 0, the damping is relative
  to the problem's scale, and a non-finite step is zeroed;
- per-factor weights carry confidence (the solver's inliers); padding
  factors carry weight 0.

The loop reads nothing back to the host: ``solve_ex`` does not check the
solve, and a ``torch.where`` zeroes a non-finite step as the JAX loop does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bufferx_tpu_torch.core.se3 import axis_angle_to_rotation, decompose, integrate

__all__ = ["PoseGraph", "pose_graph_gauss_newton", "chain_initialization"]


class PoseGraph(NamedTuple):
    """Factors: edge (i, j) measures T_ij with ``T_j ~ T_i @ T_ij``
    (world-from-frame poses)."""
    edges_i: torch.Tensor   # [E] int64
    edges_j: torch.Tensor   # [E] int64
    t_meas: torch.Tensor    # [E, 4, 4]
    weights: torch.Tensor   # [E] (0 = disabled / padding)


def chain_initialization(graph: PoseGraph, num_poses: int) -> torch.Tensor:
    """Odometry-style init on the host: compose the measurements along the
    chain edges (i, i+1) in numpy, ignoring the others. Returns [K, 4, 4] on
    the graph's device, in the measurements' dtype."""
    ei = graph.edges_i.cpu().numpy()
    ej = graph.edges_j.cpu().numpy()
    tm = graph.t_meas.cpu().numpy()
    poses = [np.eye(4, dtype=tm.dtype)]
    for k in range(1, num_poses):
        found = np.where((ei == k - 1) & (ej == k))[0]
        step = tm[found[0]] if len(found) else np.eye(4, dtype=tm.dtype)
        poses.append(poses[-1] @ step)
    return torch.from_numpy(np.stack(poses)).to(graph.t_meas.device)


def _apply_increment(poses: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Left-perturbation: T_k <- [exp(w_k), v_k] @ T_k. delta: [K, 6]."""
    R_inc = axis_angle_to_rotation(delta[:, :3])
    R, t = decompose(poses)
    return integrate(R_inc @ R, (R_inc @ t[..., None])[..., 0] + delta[:, 3:])


def _factor_residual(poses: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """Weighted chordal residual of every factor at the poses: [E, 12], the
    rotation part ``R_i R_ij - R_j`` (row-major) then ``R_i t_ij + t_i -
    t_j``."""
    Ri, ti = decompose(poses[graph.edges_i])
    Rj, tj = decompose(poses[graph.edges_j])
    Rij, tij = decompose(graph.t_meas)
    r_rot = (Ri @ Rij - Rj).reshape(-1, 9)
    r_tr = (Ri @ tij[..., None])[..., 0] + ti - tj
    return torch.cat([r_rot, r_tr], dim=-1) * graph.weights[:, None]


def _skew_rows(M: torch.Tensor) -> torch.Tensor:
    """d([w]x M)/dw for M [E, 3, n]: [E, 3, n, 3], entry (a, b, k) the
    derivative of (w x m_b)_a in w_k, where m_b is column b."""
    zero = torch.zeros_like(M[:, 0])
    m0, m1, m2 = M[:, 0], M[:, 1], M[:, 2]
    # (w x m)_0 = w1 m2 - w2 m1; (w x m)_1 = w2 m0 - w0 m2; (w x m)_2 =
    # w0 m1 - w1 m0
    return torch.stack([
        torch.stack([zero, m2, -m1], dim=-1),
        torch.stack([-m2, zero, m0], dim=-1),
        torch.stack([m1, -m0, zero], dim=-1),
    ], dim=1)


def _factor_jacobians(poses: torch.Tensor, graph: PoseGraph):
    """(J_i, J_j): each factor's weighted residual differentiated in the
    increments (w, v) of its two frames at the zero increment, [E, 12, 6]
    each. The increment turns R_k into exp([w]x) R_k and t_k into
    exp([w]x) t_k + v, whose derivative at w = 0 is [e]x applied to the
    rotated quantity."""
    Ri, ti = decompose(poses[graph.edges_i])
    Rj, tj = decompose(poses[graph.edges_j])
    Rij, tij = decompose(graph.t_meas)
    e = graph.weights.shape[0]
    eye = torch.eye(3, dtype=poses.dtype, device=poses.device).expand(e, 3, 3)
    zeros = torch.zeros(e, 9, 3, dtype=poses.dtype, device=poses.device)
    # rotation rows: d(R_i R_ij)/dw_i and -dR_j/dw_j, [E, 3, 3, 3] -> [E, 9, 3]
    d_rot_i = _skew_rows(Ri @ Rij).reshape(e, 9, 3)
    d_rot_j = -_skew_rows(Rj).reshape(e, 9, 3)
    # translation rows: d(R_i t_ij + t_i)/dw_i, d/dv_i = I; -d t_j/dw_j, -I
    d_tr_i = _skew_rows(((Ri @ tij[..., None])[..., 0] + ti)[..., None])[:, :, 0]
    d_tr_j = -_skew_rows(tj[..., None])[:, :, 0]
    J_i = torch.cat([torch.cat([d_rot_i, zeros], dim=-1),
                     torch.cat([d_tr_i, eye], dim=-1)], dim=1)
    J_j = torch.cat([torch.cat([d_rot_j, zeros], dim=-1),
                     torch.cat([d_tr_j, -eye], dim=-1)], dim=1)
    w = graph.weights[:, None, None]
    return J_i * w, J_j * w


def _accumulate_normal_eqs(poses: torch.Tensor, graph: PoseGraph,
                           num_poses: int):
    """Dense J^T J [6K, 6K] and J^T r [6K] over the given factors at the
    poses (the zero increment)."""
    k = num_poses
    J_i, J_j = _factor_jacobians(poses, graph)
    r = _factor_residual(poses, graph)
    ei, ej = graph.edges_i, graph.edges_j
    JiT, JjT = J_i.transpose(1, 2), J_j.transpose(1, 2)
    blocks = torch.cat([JiT @ J_i, JjT @ J_j, JiT @ J_j, JjT @ J_i])
    where = torch.cat([ei * k + ei, ej * k + ej, ei * k + ej, ej * k + ei])
    H = torch.zeros(k * k, 6, 6, dtype=poses.dtype, device=poses.device)
    H.index_add_(0, where, blocks)
    JTJ = H.reshape(k, k, 6, 6).permute(0, 2, 1, 3).reshape(6 * k, 6 * k)
    g = torch.zeros(k, 6, dtype=poses.dtype, device=poses.device)
    g.index_add_(0, torch.cat([ei, ej]),
                 torch.cat([(JiT @ r[..., None])[..., 0],
                            (JjT @ r[..., None])[..., 0]]))
    return JTJ, g.reshape(6 * k)


def _robust_factor_weights(poses: torch.Tensor, graph: PoseGraph, robust,
                           scale: float) -> torch.Tensor:
    """IRLS reweighting of the factor weights from the current residual
    norms (unweighted residuals)."""
    from bufferx_tpu_torch.parallel.bundle import robust_weight

    r = _factor_residual(poses, graph._replace(
        weights=torch.ones_like(graph.weights)))
    return graph.weights * robust_weight(torch.linalg.norm(r, dim=-1),
                                         robust, scale)


def pose_graph_gauss_newton(
    graph: PoseGraph,
    poses_init: torch.Tensor,     # [K, 4, 4]
    num_poses: int,
    num_iters: int = 10,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
    mesh=None,
    robust: str = "none",
    robust_scale: float = 1.0,
) -> torch.Tensor:
    """GN refinement of all frame poses. Returns [K, 4, 4] on the inputs'
    device, in their dtype.

    With ``mesh`` (:class:`~bufferx_tpu_torch.parallel.mesh.Mesh`),
    ``graph`` is this rank's shard of the factors (pad the shards to equal
    lengths with weight-0 factors) and the normal equations are summed over
    the ranks. ``robust`` ("huber" / "gm") reweights the factors from their
    chordal residual norms every iteration, so that an outlier loop closure
    is down-weighted instead of dragging the solution; any other value but
    "none" raises ``ValueError``, None included.
    """
    k6 = num_poses * 6
    poses = poses_init
    dt, dev = poses.dtype, poses.device
    anchor = torch.zeros(k6, dtype=dt, device=dev)
    anchor[:6] = anchor_weight
    for _ in range(num_iters):
        g = graph
        if robust != "none":
            g = g._replace(weights=_robust_factor_weights(poses, g, robust,
                                                          robust_scale))
        JTJ, JTr = _accumulate_normal_eqs(poses, g, num_poses)
        if mesh is not None:
            JTJ, JTr = mesh.all_reduce(JTJ), mesh.all_reduce(JTr)
        # damping relative to the problem's scale (a fixed 1e-6 vanishes
        # beside sqrt(inlier) weights and leaves weakly constrained blocks
        # near-singular in float32)
        scale = torch.clamp_min(torch.trace(JTJ) / k6, 1.0)
        JTJ = JTJ + torch.diag(anchor + damping * scale)
        step = -torch.linalg.solve_ex(JTJ, JTr)[0]
        # a non-finite step (a singular block) must not poison the whole
        # trajectory: zero it and let the next damped iteration retry
        step = torch.where(torch.isfinite(step), step, 0.0)
        poses = _apply_increment(poses, step.reshape(num_poses, 6))
    return poses
