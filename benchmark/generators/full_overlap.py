"""Full-overlap object pairs: ``synthetic_pair_full_overlap``, the same
procedural object under a random SE(3) with independent noise a side.

params: ``count``, ``num_points``, ``noise`` (m).
"""

from __future__ import annotations

from benchmark.generators.modelnet import synthetic_pair_full_overlap
from benchmark.seeding import random_state

__all__ = ["pairs"]


def pairs(seed: int, params: dict) -> list:
    """[(src, tgt, T_gt)], numpy f32."""
    return [synthetic_pair_full_overlap(
                random_state(seed, "full_overlap", i),
                num_points=int(params["num_points"]),
                noise=float(params["noise"]))
            for i in range(int(params["count"]))]
