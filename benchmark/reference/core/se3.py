"""SE(3) helpers (float32, batched-first; frozen copy).

Counterpart of :mod:`bufferx_tpu.core.se3` for the ported path: every
function broadcasts over leading axes.
"""

from __future__ import annotations

import torch

from benchmark.reference.device import constant

__all__ = ["transform", "decompose", "integrate", "rotation_z"]


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
