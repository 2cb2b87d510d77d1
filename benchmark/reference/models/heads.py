"""Matching head: the SO(2) cost volume.

Counterpart of :mod:`bufferx_tpu.models.heads`. :class:`CostVolume` is
the factored form of the JAX head.
The cost volume ``cost[s, ke, l] = des1[ke, (l-s) % L] - des2[ke, l]`` is a
circulant minus a shift-constant tensor and the first conv is linear, so
layer 1 is computed without materializing it: a circular 2D conv of des1
with the anti-diagonal-summed kernel, minus a VALID 2D conv of des2 with the
shift-summed kernel, rebuilt over the shifts by rolls. Nine more 3D convs
and a softmax expectation over the azimuth bins give a continuous rotation
index per correspondence. In training mode every BatchNorm uses the
batch's statistics (in float32; shared over ``bn_group``'s ranks when it is
set) and records them in ``bn_stats``
(:mod:`benchmark.reference.models.layers`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models.layers import ConvBNRelu

__all__ = ["CostVolume"]


class FactoredCostStem(ConvBNRelu):
    """Layer 1 of the cost net in factored (Toeplitz) form; ``weight`` is
    the direct 3D conv's [out, in, ds, dke, dl] kernel."""

    def __init__(self, azi_n: int, in_features: int = 32, features: int = 32,
                 compute_dtype: torch.dtype = torch.float32, bn_group=None):
        super().__init__(in_features, features, (3, 3, 3),
                         compute_dtype=compute_dtype, bn_group=bn_group)
        self.azi_n = azi_n

    def forward(self, des1: torch.Tensor, des2: torch.Tensor,
                bn_stats: dict | None = None) -> torch.Tensor:
        dt = self.compute_dtype
        L = self.azi_n
        k = self.weight.to(dt)                        # [O, I, ds, dke, dl]
        # W1[:, :, dke, dmi] = sum_ds k[:, :, ds, dke, ds + dmi - 2]
        w1 = []
        for dmi in range(5):
            acc = None
            for ds in range(3):
                if 0 <= ds + dmi - 2 <= 2:
                    term = k[:, :, ds, :, ds + dmi - 2]
                    acc = term if acc is None else acc + term
            w1.append(acc)
        w1 = torch.stack(w1, dim=-1)                  # [O, I, 3, 5]
        w2 = k[:, :, 0] + k[:, :, 1] + k[:, :, 2]     # [O, I, 3, 3]
        d1 = des1.to(dt)                              # [B, C, Ke, L]
        a_in = torch.cat([d1[..., -2:], d1, d1[..., :2]], dim=-1)
        A = F.conv2d(a_in, w1)                        # [B, O, Ke-2, L]
        C2d = F.conv2d(des2.to(dt), w2)               # [B, O, Ke-2, L-2]
        recon = torch.stack(
            [torch.roll(A, s, dims=3)[..., : L - 2] for s in range(L - 2)],
            dim=2,
        )                                             # [B, O, S, Ke-2, L-2]
        x = recon - C2d[:, :, None] + self.bias.to(dt).view(1, -1, 1, 1, 1)
        return torch.relu(self.norm(x, bn_stats))          # f32, both modes


class CostVolume(nn.Module):
    """src/tgt equivariant maps [B, 32, Ke, L] -> rotation bin index [B]."""

    def __init__(self, azi_n: int = 20,
                 compute_dtype: torch.dtype = torch.float32, bn_group=None):
        super().__init__()
        self.azi_n = azi_n
        self.stem = FactoredCostStem(azi_n, compute_dtype=compute_dtype,
                                     bn_group=bn_group)
        specs = [
            (32, 64, (3, 3, 3)),
            (64, 64, (3, 1, 3)),
            (64, 128, (3, 1, 3)),
            (128, 128, (3, 1, 3)),
            (128, 64, (3, 1, 3)),
            (64, 64, (3, 1, 3)),
            (64, 32, (3, 1, 3)),
            (32, 32, (3, 1, 3)),
        ]
        layers = [ConvBNRelu(ci, co, k, compute_dtype=compute_dtype,
                             bn_group=bn_group)
                  for ci, co, k in specs]
        layers.append(ConvBNRelu(32, azi_n, (2, 1, 2), use_bn=False,
                                 use_relu=False, compute_dtype=compute_dtype))
        self.layers = nn.ModuleList(layers)

    def forward(self, des1: torch.Tensor, des2: torch.Tensor,
                bn_stats: dict | None = None) -> torch.Tensor:
        x = self.stem(des1, des2, bn_stats)
        for layer in self.layers:
            x = layer(x, bn_stats)
        logits = x.reshape(x.shape[0], self.azi_n)
        prob = torch.softmax(logits, dim=-1)
        bins = torch.arange(self.azi_n, dtype=prob.dtype, device=prob.device)
        return torch.sum(prob * bins, dim=-1)
