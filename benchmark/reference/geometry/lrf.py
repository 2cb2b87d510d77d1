"""Local reference frame (LRF) estimation for patch descriptors.

Counterpart of :mod:`bufferx_tpu.geometry.lrf`: the patch normal is the
smallest-eigenvalue direction of the uncentred covariance of the
keypoint-relative offsets (invalid slots carry zero offsets), turned to
point toward the origin; patches then rotate so the normal becomes +z.
"""

from __future__ import annotations

import torch

from benchmark.reference.core.linalg import rodrigues_a_to_b, smallest_eigvec_3x3
from benchmark.reference.device import constant

__all__ = ["compute_z_axis", "align_patches"]


def compute_z_axis(delta: torch.Tensor, ref_point: torch.Tensor) -> torch.Tensor:
    """delta [K, P, 3] offsets, ref_point [K, 3] -> unit normals [K, 3]."""
    cov = torch.matmul(delta.transpose(1, 2), delta)           # [K, 3, 3]
    z = smallest_eigvec_3x3(cov)
    flip = torch.sum(-z * ref_point, dim=-1) < 0.0
    z = torch.where(flip[:, None], -z, z)
    return z / torch.clamp_min(torch.linalg.norm(z, dim=-1, keepdim=True), 1e-12)


def align_patches(delta: torch.Tensor, kpts: torch.Tensor,
                  is_aligned_to_global_z: bool | torch.Tensor):
    """Rotate patches into their LRF, or keep the global frame when the
    clouds are gravity-aligned. Returns (aligned_delta [K, P, 3],
    rand_axis [K, 3], R [K, 3, 3]) with ``aligned = delta @ R``.

    ``is_aligned_to_global_z``: a Python bool takes one branch for every
    patch; a [K] bool tensor computes both and selects per patch with
    ``torch.where``, as the JAX function does under ``vmap`` (no host
    read)."""
    k = delta.shape[0]
    per_patch = isinstance(is_aligned_to_global_z, torch.Tensor)
    if per_patch or is_aligned_to_global_z:
        R_id = torch.eye(3, dtype=delta.dtype,
                         device=delta.device).expand(k, 3, 3)
        rand_id = constant((1.0, 0.0, 0.0), delta.dtype,
                           delta.device).expand(k, 3)
        if not per_patch:
            return delta, rand_id, R_id
    z_hat = constant((0.0, 0.0, 1.0), delta.dtype,
                     delta.device).expand(k, 3)
    z = compute_z_axis(delta, kpts)
    R = rodrigues_a_to_b(z, z_hat)
    aligned = torch.matmul(delta, R)
    rand = torch.linalg.cross(z, z_hat)
    rand = rand / torch.clamp_min(torch.linalg.norm(rand, dim=-1, keepdim=True),
                                  1e-12)
    if not per_patch:
        return aligned, rand, R
    flag = is_aligned_to_global_z.reshape(k, 1, 1)
    return (torch.where(flag, delta, aligned),
            torch.where(flag[:, 0], rand_id, rand), torch.where(flag, R_id, R))
