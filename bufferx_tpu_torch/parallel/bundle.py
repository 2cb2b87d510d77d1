"""Bundle adjustment: poses and landmarks, with the Schur complement.

Counterpart of :mod:`bufferx_tpu.parallel.bundle`. Each observation couples
one frame and one landmark, so the normal equations are an arrowhead: pose
blocks ``A`` [K, 6, 6] (block-diagonal from the observations, plus the dense
coupling of optional relative-pose factors), landmark blocks ``C`` [L, 3,
3] and the coupling ``B`` [K, 6, L, 3]. The landmarks are eliminated in
closed form (batched 3x3 inverses), the reduced camera system ``S = A - B
C^-1 B^T`` [6K, 6K] is solved dense, and the landmarks are back-substituted.
The Jacobians are analytic (the left perturbation of
:func:`~bufferx_tpu_torch.parallel.posegraph._apply_increment`); robust
kernels enter as per-observation IRLS weights, recomputed every iteration.
With a :class:`~bufferx_tpu_torch.parallel.mesh.Mesh` every rank sums the
blocks of its own observations (and factors) and the sums are all-reduced.

Conventions: poses are world-from-frame ``T_i``; a landmark ``X_l`` (world)
observed from frame ``i`` measures ``z = R_i^T (X_l - t_i)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bufferx_tpu_torch.core.se3 import decompose
from bufferx_tpu_torch.parallel.posegraph import (
    PoseGraph,
    _accumulate_normal_eqs,
    _apply_increment,
)

__all__ = ["LandmarkGraph", "bundle_adjust", "robust_weight"]


class LandmarkGraph(NamedTuple):
    """Landmark observations. Padding rows: weight 0 (indices then
    ignored)."""
    obs_frame: torch.Tensor   # [M] int64: the observing frame
    obs_lm: torch.Tensor      # [M] int64: the landmark
    obs_local: torch.Tensor   # [M, 3]: measured position in frame coords
    weights: torch.Tensor     # [M]


def robust_weight(r_norm: torch.Tensor, kind: str, scale: float) -> torch.Tensor:
    """IRLS weight rho'(r)/r of residual norms. kind: none|huber|gm; any
    other value (None too) raises ``ValueError``."""
    if kind == "none":
        return torch.ones_like(r_norm)
    if kind == "huber":
        return torch.clamp_max(scale / torch.clamp_min(r_norm, 1e-12), 1.0)
    if kind == "gm":   # Geman-McClure: (s^2 / (s^2 + r^2))^2
        s2 = scale * scale
        return (s2 / (s2 + r_norm * r_norm)) ** 2
    raise ValueError(f"unknown robust kernel: {kind!r}")


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, -z, y], dim=-1),
        torch.stack([z, o, -x], dim=-1),
        torch.stack([-y, x, o], dim=-1),
    ], dim=-2)


def _obs_blocks(poses, lms, graph: LandmarkGraph, robust: str, scale: float):
    """Per-observation residuals and analytic Jacobian blocks.

    r = R_i^T (X_l - t_i) - z. The left perturbation T_i <- [exp(w), v] T_i
    and X_l <- X_l + dX give J_w = R^T [X]x, J_v = -R^T, J_X = R^T.
    Returns (r [M, 3], Jp [M, 3, 6], Jl [M, 3, 3], w [M]).
    """
    R, t = decompose(poses)
    Ri = R[graph.obs_frame]
    ti = t[graph.obs_frame]
    X = lms[graph.obs_lm]
    RiT = Ri.transpose(-1, -2)
    r = (RiT @ (X - ti)[..., None])[..., 0] - graph.obs_local
    w = graph.weights * robust_weight(torch.linalg.norm(r, dim=-1), robust,
                                      scale)
    Jp = torch.cat([RiT @ _skew(X), -RiT], dim=-1)
    return r, Jp, RiT, w


def _accumulate_arrowhead(poses, lms, graph: LandmarkGraph, num_poses: int,
                          num_lms: int, robust: str, scale: float):
    """The arrowhead blocks (A [K, 6, 6], B [K, 6, L, 3], C [L, 3, 3], b_p
    [K, 6], b_l [L, 3]) of the given observations. ``B`` is summed on the
    flattened (frame, landmark) index, so repeated pairs add up."""
    r, Jp, Jl, w = _obs_blocks(poses, lms, graph, robust, scale)
    dt, dev = poses.dtype, poses.device
    wJpT = (Jp * w[:, None, None]).transpose(1, 2)     # [M, 6, 3]
    wJlT = (Jl * w[:, None, None]).transpose(1, 2)     # [M, 3, 3]
    of, ol = graph.obs_frame, graph.obs_lm
    A = torch.zeros(num_poses, 6, 6, dtype=dt, device=dev)
    A.index_add_(0, of, wJpT @ Jp)
    C = torch.zeros(num_lms, 3, 3, dtype=dt, device=dev)
    C.index_add_(0, ol, wJlT @ Jl)
    B = torch.zeros(num_poses * num_lms, 6, 3, dtype=dt, device=dev)
    B.index_add_(0, of * num_lms + ol, wJpT @ Jl)
    B = B.reshape(num_poses, num_lms, 6, 3).permute(0, 2, 1, 3)
    bp = torch.zeros(num_poses, 6, dtype=dt, device=dev)
    bp.index_add_(0, of, (wJpT @ r[..., None])[..., 0])
    bl = torch.zeros(num_lms, 3, dtype=dt, device=dev)
    bl.index_add_(0, ol, (wJlT @ r[..., None])[..., 0])
    return A, B, C, bp, bl


def bundle_adjust(
    poses_init: torch.Tensor,     # [K, 4, 4]
    lms_init: torch.Tensor,       # [L, 3]
    obs: LandmarkGraph,
    num_poses: int,
    num_lms: int,
    pose_graph: PoseGraph | None = None,
    num_iters: int = 10,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
    robust: str = "none",
    robust_scale: float = 1.0,
    mesh=None,
):
    """Joint GN over frame poses and landmarks. Returns (poses [K, 4, 4],
    landmarks [L, 3]) on the inputs' device, in their dtype.

    ``pose_graph`` adds relative-pose factors (odometry, loop closures) to
    the pose block. With ``mesh``, ``obs`` and ``pose_graph`` are this
    rank's shards (pad them to equal lengths with weight-0 rows) and the
    blocks are summed over the ranks. No value is read back to the host.
    """
    k6 = num_poses * 6
    poses, lms = poses_init, lms_init
    dt, dev = poses.dtype, poses.device
    anchor = torch.zeros(k6, dtype=dt, device=dev)
    anchor[:6] = anchor_weight
    eye3 = torch.eye(3, dtype=dt, device=dev)
    diag = torch.arange(num_poses, device=dev)
    for _ in range(num_iters):
        parts = _accumulate_arrowhead(poses, lms, obs, num_poses, num_lms,
                                      robust, robust_scale)
        if pose_graph is not None:
            parts = parts + _accumulate_normal_eqs(poses, pose_graph,
                                                   num_poses)
        if mesh is not None:
            parts = tuple(mesh.all_reduce(p) for p in parts)
        A, B, C, bp, bl = parts[:5]

        # the pose block: observation blocks on the diagonal, plus the
        # relative-pose factors
        Af = torch.zeros(num_poses, num_poses, 6, 6, dtype=dt, device=dev)
        Af[diag, diag] = A
        Af = Af.permute(0, 2, 1, 3).reshape(k6, k6)
        bf = bp.reshape(k6)
        if pose_graph is not None:
            Af = Af + parts[5]
            bf = bf + parts[6]
        Af = Af + torch.diag(anchor + damping)
        C_d = C + damping * eye3

        # Schur: S = A - B C^-1 B^T; rhs = b_p - B C^-1 b_l
        Cinv = torch.linalg.inv_ex(C_d)[0]                   # [L, 3, 3]
        Bm = B.reshape(k6, num_lms, 3)
        BCinv = torch.einsum("ilc,lcd->ild", Bm, Cinv)       # [6K, L, 3]
        S = Af - BCinv.reshape(k6, -1) @ Bm.reshape(k6, -1).T
        rhs = bf - BCinv.reshape(k6, -1) @ bl.reshape(-1)
        dp = -torch.linalg.solve_ex(S, rhs)[0]               # [6K]
        # back-substitute the landmarks: C dX = -(b_l + B^T dp)
        Bt_dp = torch.einsum("ild,i->ld", Bm, dp)
        dX = -torch.einsum("lcd,ld->lc", Cinv, bl + Bt_dp)
        poses = _apply_increment(poses, dp.reshape(num_poses, 6))
        lms = lms + dX
    return poses, lms
