"""Per-correspondence SE(3) candidates from SO(2) rotation indices.

Counterpart of :func:`bufferx_tpu.solver.so2.so2_pose_candidates`:
R = tt_R @ Rz(angle) @ ss_R^T, t = tt_kpt - R @ ss_kpt.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.core.se3 import rotation_z

__all__ = ["so2_pose_candidates"]


def so2_pose_candidates(ss_kpts, tt_kpts, ss_R, tt_R, ind, azi_n: int):
    """[..., C, 3], [..., C, 3], [..., C, 3, 3], [..., C, 3, 3], [..., C] ->
    (R [..., C, 3, 3], t [..., C, 3])."""
    angle = ind * (2.0 * math.pi / azi_n) + 1e-6
    R = torch.matmul(torch.matmul(tt_R, rotation_z(angle)),
                     ss_R.transpose(-1, -2))
    t = tt_kpts - torch.matmul(R, ss_kpts[..., None])[..., 0]
    return R, t
