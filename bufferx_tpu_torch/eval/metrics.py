"""Registration metrics — the acceptance criteria of the benchmark.

The port's own copy of :mod:`bufferx_tpu.eval.metrics` (numpy only).

Ports the exact metric definitions (host-side numpy; these run on aggregate
results, not in the hot path):

- pairwise recall: RTE/RRE thresholds (the reference's ``test.py:167-172``)
- 3DMatch/3DLoMatch protocol: covariance-weighted transformation error
  against gt.info, success iff err² <= 0.2²
  (``utils/tools.py:97-129``, ``test.py:280-314``)
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "mat2quat",
    "transformation_error",
    "evaluate_registration_rmse",
    "pairwise_recall",
]


def mat2quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), branch-stable."""
    m = R
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _quat_imag_batch(R: np.ndarray) -> np.ndarray:
    """Batched rotation matrices [M, 3, 3] -> imaginary quaternion parts
    [M, 3], selecting per row the same numerically-stable branch as
    :func:`mat2quat` (Shepperd's method)."""
    R = np.asarray(R, np.float64)
    m00, m11, m22 = R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]
    tr = m00 + m11 + m22
    # Candidate quaternions for each of the four branches, all rows. A
    # branch's denominator is zero exactly when that branch is NOT the
    # stable one for the row (np.choose discards it below), so clamp the
    # denominators instead of letting x/0 emit RuntimeWarnings — the
    # acceptance-metric module must run warning-clean.
    s0 = np.maximum(2.0 * np.sqrt(np.maximum(tr + 1.0, 0.0)), 1e-30)
    q0 = np.stack(
        [s0 / 4,
         (R[:, 2, 1] - R[:, 1, 2]) / s0,
         (R[:, 0, 2] - R[:, 2, 0]) / s0,
         (R[:, 1, 0] - R[:, 0, 1]) / s0], axis=-1)
    s1 = np.maximum(
        2.0 * np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 0.0)), 1e-30)
    q1 = np.stack(
        [(R[:, 2, 1] - R[:, 1, 2]) / s1,
         s1 / 4,
         (R[:, 0, 1] + R[:, 1, 0]) / s1,
         (R[:, 0, 2] + R[:, 2, 0]) / s1], axis=-1)
    s2 = np.maximum(
        2.0 * np.sqrt(np.maximum(1.0 + m11 - m00 - m22, 0.0)), 1e-30)
    q2 = np.stack(
        [(R[:, 0, 2] - R[:, 2, 0]) / s2,
         (R[:, 0, 1] + R[:, 1, 0]) / s2,
         s2 / 4,
         (R[:, 1, 2] + R[:, 2, 1]) / s2], axis=-1)
    s3 = np.maximum(
        2.0 * np.sqrt(np.maximum(1.0 + m22 - m00 - m11, 0.0)), 1e-30)
    q3 = np.stack(
        [(R[:, 1, 0] - R[:, 0, 1]) / s3,
         (R[:, 0, 2] + R[:, 2, 0]) / s3,
         (R[:, 1, 2] + R[:, 2, 1]) / s3,
         s3 / 4], axis=-1)
    branch = np.where(
        tr > 0, 0,
        np.where((m00 > m11) & (m00 > m22), 1, np.where(m11 > m22, 2, 3)),
    )
    q = np.choose(branch[:, None], [q0, q1, q2, q3])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q[:, 1:]


def transformation_error(trans: np.ndarray, info: np.ndarray) -> float:
    """Covariance-weighted pose error (``utils/tools.py:97-101``).

    trans: [4, 4] relative error transform (gt⁻¹ @ est); info: [6, 6]
    information matrix from gt.info. The 6-vector residual is
    [translation, quaternion imaginary part]; the quadratic form is
    normalized by ``info[0, 0]``.
    """
    t, r = trans[:3, 3], trans[:3, :3]
    q = mat2quat(r)
    er = np.concatenate([t, q[1:]], axis=0)
    return float(er @ info @ er / info[0, 0])


def evaluate_registration_rmse(
    num_fragment: int,
    result: np.ndarray,        # [M, 4, 4] estimated poses
    result_pairs: np.ndarray,  # [M, 2] (i, j) fragment ids
    gt_pairs: np.ndarray,      # [G, 2]
    gt: np.ndarray,            # [G, 4, 4]
    gt_info: np.ndarray,       # [G, 6, 6]
    err2: float = 0.2,
):
    """3DMatch/3DLoMatch protocol recall, vectorized over pairs.

    Protocol semantics pinned to the reference's ``utils/tools.py:104-129``
    (and to the golden tests in ``tests/test_eval.py``): only loop-closure
    pairs (fragment gap > 1) are scored; an estimate succeeds when its
    covariance-weighted error against gt.info is at most ``err2`` squared.
    The reference keys eligible gt pairs through a dense id table and tests
    ``table > 0``, which silently drops gt slot 0 — real gt.log files list a
    consecutive pair first, so slot 0 is never eligible anyway; we replicate
    the behavior exactly for bit-parity.

    Returns ``(recall over evaluated, recall over gt, flags, errors)`` where
    ``flags[m]`` is 0 = success, 1 = failure, 2 = not scored, and
    ``errors[m]`` is the weighted error (NaN when not scored).
    """
    result = np.asarray(result, np.float64)
    result_pairs = np.asarray(result_pairs, np.int64)
    gt_pairs = np.asarray(gt_pairs, np.int64)
    n_est = result_pairs.shape[0]

    # dense (i, j) -> gt-slot table over loop-closure pairs only
    slot_table = np.zeros((num_fragment, num_fragment), np.int64)
    closure = gt_pairs[:, 1] - gt_pairs[:, 0] > 1
    slot_table[gt_pairs[closure, 0], gt_pairs[closure, 1]] = np.nonzero(
        closure
    )[0]
    n_gt = int(np.count_nonzero(slot_table))

    slots = slot_table[result_pairs[:, 0], result_pairs[:, 1]]
    scored = slots > 0
    errors = np.full(n_est, np.nan)
    flags = np.full(n_est, 2, np.int64)
    if np.any(scored):
        g = slots[scored]
        # relative error transform gt⁻¹ @ est for every scored pair at once
        rel = np.linalg.inv(gt[g]) @ result[scored]
        resid = np.concatenate(
            [rel[:, :3, 3], _quat_imag_batch(rel[:, :3, :3])], axis=-1
        )
        info = np.asarray(gt_info, np.float64)[g]
        werr = (
            np.einsum("mi,mij,mj->m", resid, info, resid) / info[:, 0, 0]
        )
        errors[scored] = werr
        flags[scored] = np.where(werr <= err2 * err2, 0, 1)
    good = int(np.count_nonzero(flags == 0))
    n_scored = int(np.count_nonzero(scored))
    return (
        good / max(n_scored, 1e-6),
        good / max(n_gt, 1e-6),
        flags.tolist(),
        errors,
    )


def pairwise_recall(
    rte: np.ndarray, rre: np.ndarray, rte_thresh: float, rre_thresh: float
):
    """Success mask + recall under the RTE/RRE thresholds (``test.py:167-172``)."""
    success = (np.asarray(rte) < rte_thresh) & (np.asarray(rre) < rre_thresh)
    return success, float(success.mean()) if len(success) else 0.0
