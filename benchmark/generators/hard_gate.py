"""The hard gate's scenes (the program's ``tools/exp_hard.py``): room pairs
at overlap {0.3, 0.5, 0.75} x noise {0, 0.5, 1.0} voxels; overlap x density
mismatch 4:1 and 10:1 at 0.5-voxel noise; clutter 10% and 20% at overlap
0.5, 0.5-voxel noise. ``per_cell`` pairs a scene kind, a fixed set made
from ``scene_key`` (a scene kind's pairs are consecutive); the run's seed
shuffles them within blocks of ``block`` and moves each target by a rigid
motion of its own (:mod:`motion`).

params: ``per_cell``, ``num_points``, ``voxel`` (m), the grid
``overlaps``, ``noise_vox``, ``densities``, ``clutter``, ``scene_key``,
``max_trans`` (m), ``block``.
"""

from __future__ import annotations

from benchmark.generators.hardsynth import hard_pair
from benchmark.generators.motion import reorder_and_move
from benchmark.seeding import random_state

__all__ = ["cells", "pairs"]


def cells(params: dict) -> list:
    """The gate's cells: dicts of overlap, noise_vox, density, clutter."""
    out = []
    for ov in params["overlaps"]:
        for nz in params["noise_vox"]:
            out.append(dict(overlap=ov, noise_vox=nz, density=1.0,
                            clutter=0.0))
    for ov in params["overlaps"]:
        for dr in params["densities"]:
            out.append(dict(overlap=ov, noise_vox=0.5, density=dr,
                            clutter=0.0))
    for cl in params["clutter"]:
        out.append(dict(overlap=0.5, noise_vox=0.5, density=1.0, clutter=cl))
    return out


def pairs(seed: int, params: dict) -> list:
    """[(src, tgt, T_gt)], numpy f32."""
    out = []
    key, voxel = int(params["scene_key"]), float(params["voxel"])
    for ci, cell in enumerate(cells(params)):
        for i in range(int(params["per_cell"])):
            rs = random_state(key, "hard_gate", ci * 1000 + i)
            out.append(hard_pair(
                rs, family="eval", num_points=int(params["num_points"]),
                overlap_ratio=cell["overlap"],
                noise=cell["noise_vox"] * voxel,
                density_ratio=cell["density"], outlier_frac=cell["clutter"]))
    return reorder_and_move(seed, out, float(params["max_trans"]),
                            int(params["block"]))
