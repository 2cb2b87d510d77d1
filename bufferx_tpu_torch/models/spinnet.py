"""Mini-SpinNet patch embedder, "moments" or "sampled", gated or softmax pool.

Counterpart of :class:`bufferx_tpu.models.spinnet.MiniSpinNet`. Input is
the moments-major cell features ``[K, 10, G]`` (``mode="moments"``) or the
SPT's derotated cell samples ``[K, G, ns, 3]`` (``mode="sampled"``, the
reference descriptor: a point MLP with a max over the samples); G = rad_n *
ele_n * azi_n. Output is a dict with ``desc`` [K, 32] (unit invariant
descriptors) and ``equi`` [K, 32, ele_n, azi_n] (equivariant maps, unit over
channels), the JAX package's layouts. ``fused_conv`` runs the backbone as
the fused conv stack (kernel K5) under the JAX package's condition.
``pool`` is the attention head: "gated" (the reference's: two 1x1 convs
with affine BN and ReLU, mean-pooled) or "softmax" (a bare 1x1 conv whose
logits are normalized by a softmax over the grid). ``width`` multiplies the
backbone's channels. In training mode (``.train()``) every BatchNorm uses
the batch's statistics (shared over ``bn_group``'s ranks when it is set,
the JAX module's ``bn_axis_name``) and records them in ``bn_stats``
(:mod:`bufferx_tpu_torch.models.layers`).
"""

from __future__ import annotations

import torch
from torch import nn

from bufferx_tpu_torch.kernels.conv_epilogue import conv_epilogue, to_form
from bufferx_tpu_torch.models.layers import (
    ConvBNRelu,
    CylindricalConvNet,
    FusedCylindricalConvNet,
    at_least_f32,
)

__all__ = ["MiniSpinNet", "safe_unit"]


def safe_unit(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Exact L2 unit vectors with a TINY clamp (an untrained net's pooled
    norms are genuinely ~1e-6; a larger clamp would stop normalizing)."""
    return v / torch.clamp_min(torch.linalg.norm(v, dim=dim, keepdim=True), eps)


class PointwiseStem(ConvBNRelu):
    """1x1 conv + affine BN + ReLU on channels-last input [..., C_in],
    returning [..., 16] (the JAX ``ConvBNRelu(16, (1, 1), bn_affine=True)``
    stem of the sampled mode), or the form ``out`` of it: "amax" (the max
    over the samples, [K, G, 16]) or "pad3d" (the backbone's padded input,
    ``grid`` = (rad, ele, azi))."""

    def __init__(self, features: int = 16, in_features: int = 3,
                 compute_dtype: torch.dtype = torch.float32, bn_group=None):
        super().__init__(in_features, features, (1, 1), bn_affine=True,
                         compute_dtype=compute_dtype, bn_group=bn_group)

    def conv_weights(self) -> tuple:
        return (self.weight[:, :, 0, 0].t().to(self.compute_dtype),)  # [C_in, 16]

    def forward(self, x: torch.Tensor, bn_stats: dict | None = None,
                out: str = "f32", grid: tuple | None = None) -> torch.Tensor:
        dt = self.compute_dtype
        if self.kernel_serves(x):
            (w,), const = self.serving_state()
            return conv_epilogue(torch.matmul(x.to(dt), w).contiguous(),
                                 const, out, channel_dim=-1, grid=grid)
        (w,) = self.conv_weights()
        y = torch.matmul(x.to(dt), w) + self.bias.to(dt)
        y = self.norm(y, bn_stats, channel_dim=-1)
        if not self.training:
            y = y.to(dt)
        return to_form(torch.relu(at_least_f32(y)), out, dt, grid)


class MomentsMajorStem(PointwiseStem):
    """The stem on moments-major input [K, 10, G], returning channels-last
    [K, G, 16] (the contraction reads the moments axis directly, as the JAX
    stem does)."""

    def __init__(self, features: int = 16, in_features: int = 10,
                 compute_dtype: torch.dtype = torch.float32, bn_group=None):
        super().__init__(features, in_features, compute_dtype, bn_group)

    def forward(self, x_mm: torch.Tensor, bn_stats: dict | None = None,
                out: str = "f32", grid: tuple | None = None) -> torch.Tensor:
        return super().forward(x_mm.transpose(1, 2), bn_stats, out, grid)


class MiniSpinNet(nn.Module):
    def __init__(self, rad_n: int = 3, ele_n: int = 7, azi_n: int = 20,
                 dim: int = 32, mode: str = "moments", pool: str = "gated",
                 width: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32,
                 fused_conv: bool = False, bn_group=None):
        super().__init__()
        if pool not in ("gated", "softmax"):
            raise ValueError(f"MiniSpinNet pool={pool!r}: expected 'gated' "
                             "or 'softmax'")
        if mode not in ("moments", "sampled"):
            raise ValueError(f"MiniSpinNet mode={mode!r}: expected 'moments' "
                             "or 'sampled'")
        self.mode = mode
        self.pool = pool
        self.rad_n, self.ele_n, self.azi_n = rad_n, ele_n, azi_n
        stem = MomentsMajorStem if mode == "moments" else PointwiseStem
        self.stem = stem(16, compute_dtype=compute_dtype, bn_group=bn_group)
        # the JAX package's condition; the fused module is serving-only and
        # raises in training mode
        self.fused = (fused_conv and (rad_n, ele_n, azi_n) == (3, 7, 20)
                      and compute_dtype == torch.bfloat16 and width == 1.0)
        self.backbone = (FusedCylindricalConvNet(dim) if self.fused
                         else CylindricalConvNet(dim, width, compute_dtype,
                                                 bn_group))
        self.att_hidden = ConvBNRelu(dim, 16, (1, 1), bn_affine=True,
                                     compute_dtype=compute_dtype,
                                     bn_group=bn_group)
        if pool == "softmax":
            self.att_gate = ConvBNRelu(16, 1, (1, 1), use_bn=False,
                                       use_relu=False,
                                       compute_dtype=compute_dtype)
        else:
            self.att_gate = ConvBNRelu(16, 1, (1, 1), bn_affine=True,
                                       compute_dtype=compute_dtype,
                                       bn_group=bn_group)

    def forward(self, x_in: torch.Tensor,
                bn_stats: dict | None = None) -> dict:
        k = x_in.shape[0]
        grid = (self.rad_n, self.ele_n, self.azi_n)
        g = self.rad_n * self.ele_n * self.azi_n
        # the cuDNN backbone reads its padded input from the moments stem
        padded = self.mode == "moments" and not self.fused
        if self.mode == "moments":
            if tuple(x_in.shape[1:]) != (10, g):
                raise ValueError(f"expected moments-major [K, 10, {g}], got "
                                 f"{tuple(x_in.shape)}")
            x = self.stem(x_in, bn_stats, out="pad3d" if padded else "f32",
                          grid=grid)
        else:
            if x_in.ndim != 4 or x_in.shape[1] != g or x_in.shape[3] != 3:
                raise ValueError(f"expected SPT samples [K, {g}, ns, 3], got "
                                 f"{tuple(x_in.shape)}")
            x = self.stem(x_in, bn_stats, out="amax")          # [K, G, 16]
        if padded:                            # [K, 16, rad, ele + 2, azi + 2]
            x = self.backbone(x, bn_stats, padded=True)
        else:
            x = x.reshape(k, *grid, 16).permute(0, 4, 1, 2, 3)
            x = self.backbone(x, bn_stats)                     # [K, 32, e, a]
        w = self.att_gate(self.att_hidden(x, bn_stats, out="bf16"), bn_stats)
        if self.pool == "softmax":                             # w: logits
            att = torch.softmax(w.reshape(k, -1), dim=-1).reshape(w.shape)
            f = torch.sum(x * att, dim=(2, 3))                 # [K, 32]
        else:
            f = torch.mean(x * w, dim=(2, 3))                  # [K, 32]
        return {"desc": safe_unit(f), "equi": safe_unit(x, dim=1)}
