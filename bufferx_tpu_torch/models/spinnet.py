"""Mini-SpinNet patch embedder, "moments" mode with the gated pool.

Counterpart of :class:`bufferx_tpu.models.spinnet.MiniSpinNet`. Input is the
moments-major cell features ``[K, 10, G]`` (G = rad_n * ele_n * azi_n);
output is a dict with ``desc`` [K, 32] (unit invariant descriptors) and
``equi`` [K, 32, ele_n, azi_n] (equivariant maps, unit over channels), the
JAX package's layouts. The other modes ("sampled", the softmax pool, the
fused conv stack) are not ported yet and raise.
"""

from __future__ import annotations

import torch
from torch import nn

from bufferx_tpu_torch.models.layers import (
    ConvBNRelu,
    CylindricalConvNet,
    batch_norm,
)

__all__ = ["MiniSpinNet", "safe_unit"]


def safe_unit(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Exact L2 unit vectors with a TINY clamp (an untrained net's pooled
    norms are genuinely ~1e-6; a larger clamp would stop normalizing)."""
    return v / torch.clamp_min(torch.linalg.norm(v, dim=dim, keepdim=True), eps)


class MomentsMajorStem(ConvBNRelu):
    """1x1 conv + affine BN + ReLU on moments-major input [K, 10, G],
    returning channels-last [K, G, 16] (the contraction reads the moments
    axis directly, as the JAX stem does)."""

    def __init__(self, features: int = 16, in_features: int = 10,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, features, (1, 1), bn_affine=True,
                         compute_dtype=compute_dtype)

    def forward(self, x_mm: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.weight[:, :, 0, 0].t().to(dt)                 # [10, 16]
        y = torch.matmul(x_mm.to(dt).transpose(1, 2), w)       # [K, G, 16]
        y = y + self.bias.to(dt)
        y = batch_norm(y, self.bn_mean, self.bn_var, self.bn_scale,
                       self.bn_bias, channel_dim=-1).to(dt)
        return torch.relu(y.to(torch.float32))


class MiniSpinNet(nn.Module):
    def __init__(self, rad_n: int = 3, ele_n: int = 7, azi_n: int = 20,
                 dim: int = 32, mode: str = "moments", pool: str = "gated",
                 width: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode != "moments" or pool != "gated":
            raise NotImplementedError(
                f"MiniSpinNet mode={mode!r} pool={pool!r}: only "
                "mode='moments' with pool='gated' is ported"
            )
        self.rad_n, self.ele_n, self.azi_n = rad_n, ele_n, azi_n
        self.stem = MomentsMajorStem(16, compute_dtype=compute_dtype)
        self.backbone = CylindricalConvNet(dim, width, compute_dtype)
        self.att_hidden = ConvBNRelu(dim, 16, (1, 1), bn_affine=True,
                                     compute_dtype=compute_dtype)
        self.att_gate = ConvBNRelu(16, 1, (1, 1), bn_affine=True,
                                   compute_dtype=compute_dtype)

    def forward(self, x_mm: torch.Tensor) -> dict:
        k, c, g = x_mm.shape
        if c != 10 or g != self.rad_n * self.ele_n * self.azi_n:
            raise ValueError(f"expected moments-major [K, 10, G], got "
                             f"{tuple(x_mm.shape)}")
        x = self.stem(x_mm)                                    # [K, G, 16]
        x = x.reshape(k, self.rad_n, self.ele_n, self.azi_n, 16)
        x = self.backbone(x.permute(0, 4, 1, 2, 3))            # [K, 32, e, a]
        w = self.att_gate(self.att_hidden(x))                  # [K, 1, e, a]
        f = torch.mean(x * w, dim=(2, 3))                      # [K, 32]
        return {"desc": safe_unit(f), "equi": safe_unit(x, dim=1)}
