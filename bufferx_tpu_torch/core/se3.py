"""SE(3) helpers and registration error metrics (float32, batched-first).

Counterpart of :mod:`bufferx_tpu.core.se3` for the ported path: every
function broadcasts over leading axes.
"""

from __future__ import annotations

import math

import torch

from bufferx_tpu_torch.device import constant

__all__ = ["transform", "decompose", "integrate", "concatenate", "inverse",
           "compute_rte", "compute_rre", "rotation_z",
           "axis_angle_to_rotation", "random_rotation"]


def transform(pts: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Apply an SE(3) transform, ``R @ p + t``: pts [..., N, 3], trans
    [..., 4, 4]."""
    R, t = decompose(trans)
    return torch.matmul(pts, R.transpose(-1, -2)) + t[..., None, :]


def decompose(trans: torch.Tensor):
    """[..., 4, 4] -> (R [..., 3, 3], t [..., 3])."""
    return trans[..., :3, :3], trans[..., :3, 3]


def integrate(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R [..., 3, 3], t [..., 3]) -> [..., 4, 4]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = constant((0.0, 0.0, 0.0, 1.0), R.dtype,
                      R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def concatenate(trans1: torch.Tensor, trans2: torch.Tensor) -> torch.Tensor:
    """Compose two SE(3) transforms: ``trans1 @ trans2``."""
    return trans1 @ trans2


def inverse(trans: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse (no linear solve)."""
    R, t = decompose(trans)
    Rt = R.transpose(-1, -2)
    return integrate(Rt, -(Rt @ t[..., None])[..., 0])


def compute_rte(trans_est: torch.Tensor, trans_gt: torch.Tensor) -> torch.Tensor:
    """Relative translation error: L2 of the translation difference."""
    return torch.linalg.norm(trans_est[..., :3, 3] - trans_gt[..., :3, 3],
                             dim=-1)


def compute_rre(trans_est: torch.Tensor, trans_gt: torch.Tensor) -> torch.Tensor:
    """Relative rotation error in degrees: arccos((tr(Re^T Rg) - 1) / 2)."""
    tr = torch.sum(trans_est[..., :3, :3] * trans_gt[..., :3, :3],
                   dim=(-2, -1))
    cos_theta = torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-16, 1.0 - 1e-16)
    return torch.rad2deg(torch.arccos(cos_theta))


def rotation_z(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about +z by ``angle`` (radians); broadcasts over leading axes."""
    c, s = torch.cos(angle), torch.sin(angle)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, z], dim=-1),
            torch.stack([s, c, z], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def axis_angle_to_rotation(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle vector [..., 3] -> rotation matrix [..., 3, 3],
    ``I + A K + B K^2`` with ``K = [w]x``, ``A = sin(t)/t`` and ``B = (1 -
    cos t)/t^2`` on the unnormalized axis, both replaced by their Taylor
    series below ``t^2 = 1e-8`` (smooth at the zero rotation, where the
    pose graph's increments start)."""
    w = axis_angle
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = t2 < 1e-8
    t2c = torch.clamp_min(t2, 1e-8)
    t = torch.sqrt(t2c)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2c)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    K = torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A * K + B * (K @ K)


def random_rotation(u: torch.Tensor, num_axis: int = 3,
                    magnitude: float = 1.0) -> torch.Tensor:
    """Augmentation rotation (reference ``utils/SE3.py:6-43``) from three
    uniform draws ``u`` [3] in [0, 1): the angles are ``u * 2 pi *
    magnitude``. ``num_axis=0`` is the identity (``u`` unused),
    ``num_axis=1`` rotates about z by angle 2 (outdoor augmentation), any
    other value composes ``Rx @ Ry @ Rz`` (indoor). [3, 3] on ``u``'s
    device, in its dtype."""
    if num_axis == 0:
        return torch.eye(3, dtype=u.dtype, device=u.device)
    angles = u * 2.0 * math.pi * magnitude
    rz = rotation_z(angles[2])
    if num_axis == 1:
        return rz
    c, s = torch.cos(angles[:2]), torch.sin(angles[:2])
    z, o = torch.zeros_like(c[0]), torch.ones_like(c[0])
    rx = torch.stack([torch.stack([o, z, z]), torch.stack([z, c[0], -s[0]]),
                      torch.stack([z, s[0], c[0]])])
    ry = torch.stack([torch.stack([c[1], z, s[1]]), torch.stack([z, o, z]),
                      torch.stack([-s[1], z, c[1]])])
    return rx @ ry @ rz
