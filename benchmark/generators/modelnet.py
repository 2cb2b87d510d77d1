"""Synthetic object-scale registration pairs (frozen copy of the program's
``data/modelnet.py``, numpy only, the same random streams): a procedural object with distinctive local geometry, a
partial-overlap pair cut from it (the training streams' pairs), and a
full-overlap pair under a random SE(3) for end-to-end runs without data.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_object", "make_pair_from_points", "synthetic_pair",
           "synthetic_pair_full_overlap"]


def synthetic_object(rs: np.random.RandomState, num_points: int = 8192) -> np.ndarray:
    """Bump-modulated shells plus one corrugated planar facet, [N, 3] f32."""
    parts = []
    n_shell = rs.randint(2, 4)
    for _ in range(n_shell):
        n = num_points // (n_shell + 1)
        v = rs.randn(n, 3)
        v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9
        bump = np.zeros(n)
        for _k in range(6):
            freq = rs.randn(3) * 4.0
            bump += rs.uniform(0.3, 1.0) * np.sin(v @ freq + rs.uniform(0, 2 * np.pi))
        r = 1.0 + 0.25 * bump / 6.0 * 6.0 ** 0.5
        radii = rs.uniform(0.25, 0.5, size=3)
        center = rs.uniform(-0.3, 0.3, size=3)
        parts.append(v * r[:, None] * radii + center)
    n = num_points - sum(len(p) for p in parts)
    uv = rs.uniform(-0.5, 0.5, size=(n, 2))
    h = np.zeros(n)
    for _k in range(4):
        freq = rs.randn(2) * 8.0
        h += rs.uniform(0.3, 1.0) * np.sin(uv @ freq + rs.uniform(0, 2 * np.pi))
    normal = rs.randn(3)
    normal /= np.linalg.norm(normal)
    basis = np.linalg.svd(np.eye(3) - np.outer(normal, normal))[0][:, :2]
    facet = uv @ basis.T + (0.05 * h)[:, None] * normal
    parts.append(facet + rs.uniform(-0.2, 0.2, size=3))
    return np.concatenate(parts).astype(np.float32)


def _random_pose(rs: np.random.RandomState, max_angle=np.pi, max_trans=0.5):
    axis = rs.randn(3)
    axis /= np.linalg.norm(axis)
    angle = rs.uniform(0, max_angle)
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rs.uniform(-max_trans, max_trans, size=3)
    return T


def make_pair_from_points(points: np.ndarray, rs: np.random.RandomState,
                          overlap: float = 0.7, noise: float = 0.005):
    """Half-space crops with the given overlap; the target gets a random
    SE(3). Returns (src, tgt, T_gt) with tgt ~ T_gt @ src on the overlap."""
    d = rs.randn(3)
    d /= np.linalg.norm(d)
    proj = points @ d
    lo, hi = np.quantile(proj, [1.0 - overlap, overlap])
    src = points[proj <= hi]
    tgt_base = points[proj >= lo]

    T = _random_pose(rs)
    tgt = tgt_base @ T[:3, :3].T + T[:3, 3]
    src = src + rs.randn(*src.shape).astype(np.float32) * noise
    tgt = tgt + rs.randn(*tgt.shape).astype(np.float32) * noise
    return src.astype(np.float32), tgt.astype(np.float32), T


def synthetic_pair(rs: np.random.RandomState, num_points: int = 8192,
                   overlap: float = 0.7, noise: float = 0.002):
    """Procedural object -> partial-overlap pair with known ground truth."""
    obj = synthetic_object(rs, num_points)
    return make_pair_from_points(obj, rs, overlap=overlap, noise=noise)


def synthetic_pair_full_overlap(rs: np.random.RandomState,
                                num_points: int = 8192, noise: float = 0.002):
    """Identical geometry under a random SE(3), independent noise per side.
    Returns (src [N, 3], tgt [N, 3], T_gt [4, 4]) with tgt ~ T_gt @ src."""
    obj = synthetic_object(rs, num_points)
    T = _random_pose(rs)
    src = obj + rs.randn(*obj.shape).astype(np.float32) * noise
    tgt = (obj @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    tgt = tgt + rs.randn(*obj.shape).astype(np.float32) * noise
    return src.astype(np.float32), tgt, T
