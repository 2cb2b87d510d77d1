"""Matching heads: equivariant correlation and the SO(2) cost volume.

Counterpart of :mod:`bufferx_tpu.models.heads`. :func:`equi_match_scores`
correlates two equivariant maps over every azimuth shift (the Desc stage's
classification logits). :class:`CostVolume` is the factored form of the
JAX head.
The cost volume ``cost[s, ke, l] = des1[ke, (l-s) % L] - des2[ke, l]`` is a
circulant minus a shift-constant tensor and the first conv is linear, so
layer 1 is computed without materializing it: a circular 2D conv of des1
with the anti-diagonal-summed kernel, minus a VALID 2D conv of des2 with the
shift-summed kernel, rebuilt over the shifts by rolls. Nine more 3D convs
and a softmax expectation over the azimuth bins give a continuous rotation
index per correspondence. In training mode every BatchNorm uses the
batch's statistics (in float32; shared over ``bn_group``'s ranks when it is
set) and records them in ``bn_stats``
(:mod:`bufferx_tpu_torch.models.layers`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bufferx_tpu_torch.kernels.conv_epilogue import conv_epilogue, to_form
from bufferx_tpu_torch.models.layers import ConvBNRelu

__all__ = ["equi_match_scores", "CostVolume"]


def equi_match_scores(des1: torch.Tensor, des2: torch.Tensor,
                      azi_n: int) -> torch.Tensor:
    """Correlation over cyclic azimuth shifts: [B, C, K, L] x2 -> [B, azi_n],
    ``out[b, s] = sum des1[b, c, k, (l - s) % L] des2[b, c, k, l]``."""
    l_idx = torch.arange(azi_n, device=des1.device)
    gather = (l_idx[None, :] - l_idx[:, None]) % azi_n        # [shift, L]
    rolled = des1[..., gather]                                # [B, C, K, S, L]
    return torch.einsum("bcksl,bckl->bs", rolled, des2)


class FactoredCostStem(ConvBNRelu):
    """Layer 1 of the cost net in factored (Toeplitz) form; ``weight`` is
    the direct 3D conv's [out, in, ds, dke, dl] kernel."""

    serving_rounds_bn = False      # float32 on; layer 1 rounds it

    def __init__(self, azi_n: int, in_features: int = 32, features: int = 32,
                 compute_dtype: torch.dtype = torch.float32, bn_group=None):
        super().__init__(in_features, features, (3, 3, 3),
                         compute_dtype=compute_dtype, bn_group=bn_group)
        self.azi_n = azi_n

    def conv_weights(self) -> tuple:
        """(W1 [O, I, 3, 5], W2 [O, I, 3, 3]) in the compute dtype."""
        k = self.weight.to(self.compute_dtype)        # [O, I, ds, dke, dl]
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
        return w1, w2

    def forward(self, des1: torch.Tensor, des2: torch.Tensor,
                bn_stats: dict | None = None,
                out: str = "f32") -> torch.Tensor:
        dt = self.compute_dtype
        L = self.azi_n
        serve = self.kernel_serves(des1, des2)
        (w1, w2), const = (self.serving_state() if serve
                           else (self.conv_weights(), None))
        d1 = des1.to(dt)                              # [B, C, Ke, L]
        a_in = torch.cat([d1[..., -2:], d1, d1[..., :2]], dim=-1)
        A = F.conv2d(a_in, w1)                        # [B, O, Ke-2, L]
        C2d = F.conv2d(des2.to(dt), w2)               # [B, O, Ke-2, L-2]
        if serve:
            return conv_epilogue(A.contiguous(), const, out,
                                 c2d=C2d.contiguous())
        recon = torch.stack(
            [torch.roll(A, s, dims=3)[..., : L - 2] for s in range(L - 2)],
            dim=2,
        )                                             # [B, O, S, Ke-2, L-2]
        x = recon - C2d[:, :, None] + self.bias.to(dt).view(1, -1, 1, 1, 1)
        y = torch.relu(self.norm(x, bn_stats))        # f32, both modes
        return to_form(y, out, dt)


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
        x = self.stem(des1, des2, bn_stats, out="bf16")
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x, bn_stats, out="f32" if i == last else "bf16")
        logits = x.reshape(x.shape[0], self.azi_n)
        prob = torch.softmax(logits, dim=-1)
        bins = torch.arange(self.azi_n, dtype=prob.dtype, device=prob.device)
        return torch.sum(prob * bins, dim=-1)
