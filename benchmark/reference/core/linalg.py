"""Batched small-matrix linear algebra (float32, branch-free).

Counterpart of :mod:`bufferx_tpu.core.linalg`:

- ``eigh3x3`` / ``smallest_eigvec_3x3``: closed-form symmetric 3x3
  eigendecomposition (trigonometric method) for the LRF normal;
- ``kabsch``: weighted rigid alignment by Horn's quaternion method, the top
  eigenvector of the 4x4 Davenport matrix found by repeated squaring plus
  two power steps (always a proper rotation, batches to millions);
- ``rodrigues_a_to_b``: the minimal rotation taking one unit vector to
  another, in the row-vector convention ``v @ R``.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.device import constant

__all__ = [
    "eigh3x3",
    "smallest_eigvec_3x3",
    "kabsch",
    "rodrigues_a_to_b",
    "quaternion_to_rotation",
    "take_rows",
]

_EPS = 1e-12


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), _EPS)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-batch row gather: x [B, N, ...], idx [B, M] -> [B, M, ...]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


def eigh3x3(A: torch.Tensor):
    """Symmetric [..., 3, 3] -> (eigvals [..., 3] ascending, eigvecs
    [..., 3, 3] with column i the i-th eigenvector). Nearly diagonal input
    falls back to the coordinate axes ordered by the diagonal."""
    A = 0.5 * (A + A.transpose(-1, -2))
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2, _EPS) / 6.0)

    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    lam2 = q + 2.0 * p * torch.cos(phi)                          # largest
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)    # smallest
    lam1 = 3.0 * q - lam0 - lam2
    eigvals = torch.stack([lam0, lam1, lam2], dim=-1)

    diag_case = p1 < _EPS * torch.clamp_min(q * q, 1.0)

    def one_vec(lam):
        r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
        r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
        r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
        crosses = torch.stack(
            [torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
             torch.linalg.cross(r1, r2)], dim=-2,
        )                                                        # [..., 3, 3]
        norms = torch.sum(crosses * crosses, dim=-1)             # [..., 3]
        best = torch.argmax(norms, dim=-1)
        v = torch.gather(
            crosses, -2, best[..., None, None].expand(best.shape + (1, 3))
        )[..., 0, :]
        return _unit(v)

    v0 = one_vec(lam0)
    v2 = one_vec(lam2)
    v1 = _unit(torch.linalg.cross(v2, v0))
    v0 = _unit(torch.linalg.cross(v1, v2))

    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    diag = torch.stack([a00, a11, a22], dim=-1)
    order = torch.argsort(diag, dim=-1, stable=True)             # ascending
    eye_sorted = torch.gather(
        eye, -1, order[..., None, :].expand(order.shape[:-1] + (3, 3))
    )
    diag_vals = torch.gather(diag, -1, order)

    vecs = torch.stack([v0, v1, v2], dim=-1)
    dcase = diag_case[..., None]
    eigvals = torch.where(dcase, diag_vals, eigvals)
    vecs = torch.where(dcase[..., None], eye_sorted, vecs)
    return eigvals, vecs


def smallest_eigvec_3x3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of a symmetric 3x3 batch."""
    return eigh3x3(A)[1][..., :, 0]


def quaternion_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation [..., 3, 3]."""
    q = _unit(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _horn_quaternion_rotation(H: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Optimal rotation from a 3x3 cross-covariance by Horn's method."""
    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    rows = [
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy],
    ]
    N = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    # shift to a positive-definite matrix with the same top eigenvector,
    # scale to spectral radius <= 1, then amplify the gap by squaring
    norm_f = torch.sqrt(torch.sum(N * N, dim=(-2, -1), keepdim=True))
    shift = norm_f + 1e-6
    eye = torch.eye(4, dtype=N.dtype, device=N.device)
    Ns = (N + shift * eye) / (2.0 * shift)
    for _ in range(max(3, min(12, iters // 2))):
        Ns = torch.matmul(Ns, Ns)
        Ns = Ns / torch.clamp_min(
            torch.sqrt(torch.sum(Ns * Ns, dim=(-2, -1), keepdim=True)), _EPS
        )
    q = torch.full(N.shape[:-1], 0.5, dtype=N.dtype, device=N.device)
    for _ in range(2):
        q = _unit(torch.matmul(Ns, q[..., None])[..., 0])
    return quaternion_to_rotation(q)


def kabsch(A: torch.Tensor, B: torch.Tensor,
           weights: torch.Tensor | None = None, iters: int = 30):
    """Weighted rigid alignment minimizing sum w |R a + t - b|^2.

    A, B: [..., N, 3]; weights [..., N] (zero drops a pair). Returns
    (R [..., 3, 3], t [..., 3])."""
    if weights is None:
        weights = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    w = weights[..., None]
    wsum = torch.sum(w, dim=-2, keepdim=True)
    centroid_A = torch.sum(A * w, dim=-2, keepdim=True) / (wsum + 1e-6)
    centroid_B = torch.sum(B * w, dim=-2, keepdim=True) / (wsum + 1e-6)
    Am = A - centroid_A
    Bm = B - centroid_B
    H = torch.matmul((Am * w).transpose(-1, -2), Bm)
    R = _horn_quaternion_rotation(H, iters=iters)
    t = centroid_B[..., 0, :] - torch.matmul(R, centroid_A[..., 0, :, None])[..., 0]
    return R, t


def rodrigues_a_to_b(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """R such that ``v @ R`` maps the frame with ``a`` as +z onto ``b``
    (antiparallel input picks any axis orthogonal to ``a``)."""
    a = _unit(a)
    b = _unit(b)
    c = torch.linalg.cross(a, b)
    s2 = torch.sum(c * c, dim=-1)
    cos = torch.clamp(torch.sum(a * b, dim=-1), -1.0, 1.0)

    ex = constant((1.0, 0.0, 0.0), a.dtype, a.device)
    ey = constant((0.0, 1.0, 0.0), a.dtype, a.device)
    alt = _unit(torch.linalg.cross(
        a, torch.where(torch.abs(a[..., :1]) < 0.9, ex, ey)
    ))
    use_alt = s2 < _EPS
    axis = torch.where(
        use_alt[..., None], alt,
        c / torch.clamp_min(torch.sqrt(s2)[..., None], _EPS),
    )
    theta = torch.arccos(cos)
    kx, ky, kz = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack(
        [
            torch.stack([zero, -kz, ky], dim=-1),
            torch.stack([kz, zero, -kx], dim=-1),
            torch.stack([-ky, kx, zero], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    st = torch.sin(theta)[..., None, None]
    ct = torch.cos(theta)[..., None, None]
    R = eye + st * K + (1.0 - ct) * torch.matmul(K, K)
    return R.transpose(-1, -2)
