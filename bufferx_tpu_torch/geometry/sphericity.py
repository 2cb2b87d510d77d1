"""Host-side geometric bootstrapping: PCA sphericity + adaptive voxel size.

The port's own copy of :mod:`bufferx_tpu.geometry.sphericity` (numpy only).

Numpy port of ``sphericity_based_voxel_analysis`` and
``compute_pca_alignment`` (the reference's ``utils/tools.py:132-198``): runs
in the input pipeline (ragged clouds, file I/O side), so it stays on host —
only its fixed-shape outputs (voxel size, alignment flag) reach the device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["compute_pca_alignment", "sphericity_based_voxel_analysis"]


def compute_pca_alignment(pts: np.ndarray, rng: np.random.RandomState | None = None):
    """PCA over a 1/10 subsample: (sphericity, is_z_aligned, components, mean)."""
    rng = rng or np.random
    num = len(pts)
    sample = pts[rng.choice(num, size=max(num // 10, min(num, 3)), replace=False)]
    mean = sample.mean(axis=0)
    centered = sample - mean
    cov = centered.T @ centered / max(len(sample) - 1, 1)
    eigvals, eigvecs = np.linalg.eigh(cov)        # ascending
    lam1, lam3 = eigvals[2], eigvals[0]
    sphericity = lam3 / max(lam1, 1e-12)
    z_candidate = eigvecs[:, 0] / max(np.linalg.norm(eigvecs[:, 0]), 1e-12)
    is_aligned = abs(np.dot(z_candidate, [0.0, 0.0, 1.0])) > 0.98
    return sphericity, is_aligned, eigvecs, mean


def sphericity_based_voxel_analysis(
    src_pts: np.ndarray,
    tgt_pts: np.ndarray,
    rng: np.random.RandomState | None = None,
):
    """Estimate (voxel_size, sphericity, is_aligned_to_global_z) for a pair.

    voxel_size = sqrt(z_range of the denser cloud in its PCA frame) / 100 *
    alpha, alpha = 1.0 for planar scenes (sphericity < 0.05) else 1.5 —
    the reference's adaptive voxelization rule (``utils/tools.py:181-185``).
    """
    s_sph, s_aligned, s_vecs, s_mean = compute_pca_alignment(src_pts, rng)
    t_sph, t_aligned, t_vecs, t_mean = compute_pca_alignment(tgt_pts, rng)

    if len(src_pts) > len(tgt_pts):
        ref, sph, vecs, mean = src_pts, s_sph, s_vecs, s_mean
    else:
        ref, sph, vecs, mean = tgt_pts, t_sph, t_vecs, t_mean

    # PCA "z" = last component in the reference's explained-variance order
    # (descending), i.e. the smallest-eigenvalue direction.
    projected = (ref - mean) @ vecs[:, 0]
    z_range = projected.max() - projected.min()
    alpha = 1.0 if sph < 0.05 else 1.5
    voxel_size = max(float(np.sqrt(z_range) / 100.0 * alpha), 0.001)

    z_src = s_vecs[:, 0] / max(np.linalg.norm(s_vecs[:, 0]), 1e-12)
    z_tgt = t_vecs[:, 0] / max(np.linalg.norm(t_vecs[:, 0]), 1e-12)
    same_direction = abs(np.dot(z_src, z_tgt)) > 0.96
    is_aligned = bool(s_aligned and t_aligned and same_direction)

    return round(voxel_size, 4), float(sph), is_aligned
