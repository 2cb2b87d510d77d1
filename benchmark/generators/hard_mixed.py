"""Mixed-hardness room pairs: ``hard_pair(family="eval")`` scenes whose
overlap, noise and density mismatch vary pair by pair.

The pairs are a fixed set, made from ``scene_key``: the overlaps are the
``count`` midpoint quantiles of U(``overlap``), and the noise levels and
density ratios are dealt out over the ``count`` pairs in an order drawn
from the key. The run's seed shuffles the pairs within blocks of
``block`` and moves each target by a rigid motion of its own
(:mod:`motion`), so every seed sends the same work.

params: ``count``, ``num_points``, ``overlap`` [lo, hi], ``noise`` (m, a
list), ``density`` (a list of ratios), ``scene_key``, ``max_trans`` (m),
``block``.
"""

from __future__ import annotations

import numpy as np

from benchmark.generators.hardsynth import hard_pair
from benchmark.generators.motion import reorder_and_move
from benchmark.seeding import random_state

__all__ = ["settings", "pairs"]


def settings(key: int, params: dict) -> list:
    """(overlap, noise, density) a pair, in the key's order."""
    n = int(params["count"])
    lo, hi = params["overlap"]
    overlaps = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    noise = [params["noise"][k % len(params["noise"])] for k in range(n)]
    density = [params["density"][k % len(params["density"])]
               for k in range(n)]
    rs = random_state(key, "hard_mixed.order")
    perm_n, perm_d = rs.permutation(n), rs.permutation(n)
    order = rs.permutation(n)
    return [(float(overlaps[order[i]]), float(noise[perm_n[i]]),
             float(density[perm_d[i]])) for i in range(n)]


def pairs(seed: int, params: dict) -> list:
    """[(src [N, 3], tgt [M, 3], T_gt [4, 4])], numpy f32."""
    key = int(params["scene_key"])
    fixed = [hard_pair(random_state(key, "hard_mixed", i), family="eval",
                       num_points=int(params["num_points"]),
                       overlap_ratio=ov, noise=nz, density_ratio=dr)
             for i, (ov, nz, dr) in enumerate(settings(key, params))]
    return reorder_and_move(seed, fixed, float(params["max_trans"]),
                            int(params["block"]))
