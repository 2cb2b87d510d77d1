"""Graduated non-convexity (GNC-TLS) robust pose solver.

Counterpart of :func:`bufferx_tpu.solver.gnc.gnc_tls_solve`: GNC with the
truncated-least-squares surrogate over the correspondence set, a closed-form
weighted-Kabsch inner step, the control parameter ``mu`` annealed by a fixed
factor over a fixed number of rounds; batched linear algebra without a
branch on a value. Every argument may carry leading batch dimensions (the
pairs of a batch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bufferx_tpu_torch.core.linalg import kabsch
from bufferx_tpu_torch.core.se3 import integrate

__all__ = ["gnc_tls_solve", "GncResult"]


class GncResult(NamedTuple):
    pose: torch.Tensor          # [..., 4, 4]
    num_inliers: torch.Tensor   # [...] int64
    weights: torch.Tensor       # [..., C] final TLS weights, 0 or 1


def gnc_tls_solve(src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
                  noise_bound: float, num_iters: int = 50,
                  gnc_factor: float = 1.4) -> GncResult:
    """src/tgt [..., C, 3], valid [..., C] bool."""
    eps2 = noise_bound * noise_bound
    vf = valid.to(src.dtype)

    def residuals(R, t):
        warped = torch.matmul(src, R.transpose(-1, -2)) + t[..., None, :]
        return torch.sum((warped - tgt) ** 2, dim=-1)           # squared

    # init: plain (valid-)weighted Kabsch
    R, t = kabsch(src, tgt, vf)
    r2 = residuals(R, t)
    r2max = torch.amax(torch.where(valid, r2, torch.zeros_like(r2)), dim=-1)
    mu = eps2 / torch.clamp_min(2.0 * r2max - eps2, 1e-12)
    mu = torch.clamp_min(mu, 1e-8)[..., None]                   # [..., 1]

    for _ in range(num_iters):
        r2 = residuals(R, t)
        # TLS weight update (closed form): 1 below lb, 0 above ub, and
        # sqrt(eps2 mu (mu + 1) / r2) - mu between
        lb = (mu / (mu + 1.0)) * eps2
        ub = ((mu + 1.0) / mu) * eps2
        mid = torch.sqrt(eps2 * mu * (mu + 1.0)
                         / torch.clamp_min(r2, 1e-12)) - mu
        w = torch.where(r2 <= lb, torch.ones_like(r2),
                        torch.where(r2 >= ub, torch.zeros_like(r2), mid))
        w = torch.clamp(w, 0.0, 1.0) * vf
        # degenerate guard: at least 3 points with any support
        w_ok = torch.sum(w > 1e-12, dim=-1, keepdim=True) >= 3
        w = torch.where(w_ok, w, vf)
        R, t = kabsch(src, tgt, w)
        mu = mu * gnc_factor

    inlier = (residuals(R, t) <= eps2) & valid
    return GncResult(integrate(R, t), torch.sum(inlier, dim=-1),
                     inlier.to(src.dtype))
