"""What a run's seed does to a fixed set of pairs: it shuffles them within
blocks of ``block`` pairs and moves each target by a rigid motion of its
own.

Registration is invariant to a rigid motion of the target, so every seed
sends the same pairs, of the same difficulty, under other poses (the pose
of each pair and its ground truth move together). The shuffle stays within
blocks because two-phase serving's work depends on which pairs share a
batch (a batch with any pair to redo pays a pass through every scale):
with blocks of the batch size, every seed sends the same batches in the
same sequence, so the seed changes the inputs and not the amount of work.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.seeding import random_state

__all__ = ["random_motion", "reorder_and_move"]


def random_motion(rs: np.random.RandomState, max_trans: float) -> np.ndarray:
    """A uniform random rotation (from a uniform unit quaternion) and a
    translation uniform in [-max_trans, max_trans]^3, as a 4x4 f64."""
    u1, u2, u3 = rs.uniform(0.0, 1.0, 3)
    a, b = math.sqrt(1.0 - u1), math.sqrt(u1)
    x, y = a * math.sin(2 * math.pi * u2), a * math.cos(2 * math.pi * u2)
    z, w = b * math.sin(2 * math.pi * u3), b * math.cos(2 * math.pi * u3)
    m = np.eye(4)
    m[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)],
                 [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)],
                 [2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)]]
    m[:3, 3] = rs.uniform(-max_trans, max_trans, 3)
    return m


def reorder_and_move(seed: int, pairs: list, max_trans: float,
                     block: int) -> list:
    """``pairs`` [(src, tgt, T_gt)] shuffled by the seed within each block
    of ``block``, each target moved by the seed's motion M of that pair:
    (src, M tgt, M T_gt)."""
    rs = random_state(seed, "motion")
    order = np.concatenate([start + rs.permutation(min(block,
                                                       len(pairs) - start))
                            for start in range(0, len(pairs), block)])
    out = []
    for i in order:
        src, tgt, t_gt = pairs[i]
        m = random_motion(rs, max_trans)
        moved = tgt.astype(np.float64) @ m[:3, :3].T + m[:3, 3]
        out.append((src, moved.astype(np.float32),
                    (m @ t_gt.astype(np.float64)).astype(np.float32)))
    return out
