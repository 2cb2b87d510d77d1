"""Cylindrical padding and conv stacks (channels-first, cuDNN convs).

Counterpart of :mod:`bufferx_tpu.models.layers`. The azimuth axis is
periodic: convolutions wrap it and zero-pad elevation. The JAX package is
channel-last; the port keeps PyTorch's channels-first layout inside
(``[K, C, ele, azi]`` and ``[K, C, rad, ele, azi]``) and converts kernels
once when loading (``tools/weights.py``).

:class:`ConvBNRelu` reproduces the JAX layer's rounding in bf16 serving
mode: the conv and its bias add run in the compute dtype, BatchNorm (from
running statistics, eps 1e-5) runs in float32 on that result and rounds
back to the compute dtype, and the output is float32.

In training mode (``module.train()``, the JAX layers' ``train=True``)
BatchNorm normalizes with the batch's statistics in float32, as flax's
``BatchNorm`` with ``use_fast_variance=True`` computes them: the mean and
the biased variance ``mean(x^2) - mean(x)^2`` clamped at 0, over every axis
but the channels. The forward does not touch the running statistics: it
records the batch's (mean, var) in the ``bn_stats`` dict it is given, keyed
by the layer, and :func:`running_stats` folds them into new running
statistics (``0.9 old + 0.1 batch``) for the caller to store.

With a ``bn_group`` (a :class:`~benchmark.reference.parallel.mesh.Mesh`, the
counterpart of the JAX layers' ``bn_axis_name``) the training statistics
are shared by the group's ranks, as flax's ``BatchNorm(axis_name=...)``
shares them: each rank's (mean, mean of squares) is averaged over the
ranks before the variance is formed, and the gradient flows back through
that average to every rank.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.kernels.conv_pallas import (
    cyl_conv_stack,
    fold_cyl_stack,
)

__all__ = ["pad_cyl_2d", "pad_cyl_3d", "ConvBNRelu", "CylindricalConvNet",
           "FusedCylindricalConvNet", "at_least_f32",
           "batch_norm", "batch_moments"]

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def _wrap_last(x: torch.Tensor, p: int) -> torch.Tensor:
    return torch.cat([x[..., -p:], x, x[..., :p]], dim=-1)


def pad_cyl_2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """x [K, C, ele, azi]: wrap azimuth, zero-pad elevation for odd k."""
    p = (k - 1) // 2
    if p == 0:
        return x
    return F.pad(_wrap_last(x, p), (0, 0, p, p))


def pad_cyl_3d(x: torch.Tensor, k: int) -> torch.Tensor:
    """x [K, C, rad, ele, azi]: wrap azimuth + zero elevation; the radial
    axis stays unpadded (the first conv collapses rad 3 -> 1)."""
    p = (k - 1) // 2
    if p == 0:
        return x
    return F.pad(_wrap_last(x, p), (0, 0, p, p, 0, 0))


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is when wider (flax computes BatchNorm in
    at least float32; a float64 model stays float64, which the tests use as
    a reference)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def batch_norm(x: torch.Tensor, mean, var, scale=None, bias=None,
               channel_dim: int = 1) -> torch.Tensor:
    """BatchNorm from given statistics in (at least) float32, flax's order
    of operations."""
    shape = [1] * x.ndim
    shape[channel_dim] = -1
    mul = torch.rsqrt(var + BN_EPS)
    if scale is not None:
        mul = mul * scale
    y = (at_least_f32(x) - mean.view(shape)) * mul.view(shape)
    if bias is not None:
        y = y + bias.view(shape)
    return y


def batch_moments(x: torch.Tensor, channel_dim: int = 1, group=None):
    """Training BatchNorm statistics of ``x`` per channel, in (at least)
    float32: the mean and the biased variance ``mean(x^2) - mean(x)^2``
    clamped at 0. With ``group`` (a ``Mesh``) the mean and the mean of
    squares are first averaged over its ranks, with gradient."""
    x = at_least_f32(x)
    dims = [d for d in range(x.ndim) if d != channel_dim % x.ndim]
    mean = torch.mean(x, dim=dims)
    mean2 = torch.mean(x * x, dim=dims)
    if group is not None:
        mean, mean2 = group.mean_with_grad(torch.stack([mean, mean2]))
    return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


class ConvBNRelu(nn.Module):
    """VALID conv + optional BatchNorm + optional ReLU.

    ``weight`` is [out, in, *kernel]; BatchNorm keeps its running
    statistics in the buffers ``bn_mean``/``bn_var`` and, when affine,
    ``bn_scale``/``bn_bias``. In training mode BatchNorm uses the batch's
    statistics, shared over ``bn_group``'s ranks when it is set, and records
    them in ``bn_stats`` (see the module notes)."""

    def __init__(self, in_features: int, features: int, kernel: Sequence[int],
                 use_bn: bool = True, use_relu: bool = True,
                 bn_affine: bool = False,
                 compute_dtype: torch.dtype = torch.float32, bn_group=None):
        super().__init__()
        self.bn_group = bn_group
        self.kernel = tuple(kernel)
        self.use_bn = use_bn
        self.use_relu = use_relu
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.zeros(features, in_features, *kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        if use_bn:
            self.register_buffer("bn_mean", torch.zeros(features))
            self.register_buffer("bn_var", torch.ones(features))
            if bn_affine:
                self.bn_scale = nn.Parameter(torch.ones(features))
                self.bn_bias = nn.Parameter(torch.zeros(features))
        self.bn_affine = bn_affine

    def norm(self, y: torch.Tensor, bn_stats: dict | None = None,
             channel_dim: int = 1) -> torch.Tensor:
        """BatchNorm in float32: from the running statistics, or in training
        mode from the batch's, which go into ``bn_stats`` when given."""
        scale = self.bn_scale if self.bn_affine else None
        bias = self.bn_bias if self.bn_affine else None
        if not self.training:
            return batch_norm(y, self.bn_mean, self.bn_var, scale, bias,
                              channel_dim)
        mean, var = batch_moments(y, channel_dim, self.bn_group)
        if bn_stats is not None:
            bn_stats[self] = (mean, var)
        return batch_norm(y, mean, var, scale, bias, channel_dim)

    def forward(self, x: torch.Tensor,
                bn_stats: dict | None = None) -> torch.Tensor:
        dt = self.compute_dtype
        conv = F.conv2d if len(self.kernel) == 2 else F.conv3d
        y = conv(x.to(dt), self.weight.to(dt))
        y = y + self.bias.to(dt).view((1, -1) + (1,) * len(self.kernel))
        if self.use_bn:
            y = self.norm(y, bn_stats)
            if not self.training:     # serving keeps the compute dtype
                y = y.to(dt)
        y = at_least_f32(y)
        return torch.relu(y) if self.use_relu else y


class CylindricalConvNet(nn.Module):
    """Descriptor backbone: one 3x3x3 conv collapsing the radial axis, then
    seven 3x3 cylindrical convs (affine-free BN), a bare last conv.

    Input [K, 16, rad=3, ele, azi] -> output [K, dim, ele, azi] f32."""

    def __init__(self, dim: int = 32, width: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32, bn_group=None):
        super().__init__()

        def w(c):
            return max(int(round(c * width)), 8)

        chans = [16, w(64), w(64), w(128), w(128), w(64), w(64), w(32)]
        layers = [ConvBNRelu(16, chans[1], (3, 3, 3),
                             compute_dtype=compute_dtype, bn_group=bn_group)]
        for cin, cout in zip(chans[1:-1], chans[2:]):
            layers.append(ConvBNRelu(cin, cout, (3, 3),
                                     compute_dtype=compute_dtype,
                                     bn_group=bn_group))
        layers.append(ConvBNRelu(chans[-1], dim, (3, 3), use_bn=False,
                                 use_relu=False, compute_dtype=compute_dtype))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor,
                bn_stats: dict | None = None) -> torch.Tensor:
        x = self.layers[0](pad_cyl_3d(x, 3), bn_stats)[:, :, 0]  # rad 3 -> 1
        for layer in self.layers[1:]:
            x = layer(pad_cyl_2d(x, 3), bn_stats)
        return x


class FusedCylindricalConvNet(CylindricalConvNet):
    """Inference form of :class:`CylindricalConvNet` as ONE fused program
    (kernel K5, ``kernels/conv_pallas.py``), BatchNorm folded into the
    weights. Counterpart of :class:`bufferx_tpu.models.layers.
    FusedCylindricalConvNet`.

    Parameter and buffer names are those of the bf16 ``CylindricalConvNet``,
    so the same state dicts load with ``strict=True``. The fold runs once,
    when the module is built and after every ``load_state_dict``, into the
    non-persistent buffers ``folded_w`` [5328, 128] bf16 and ``folded_b``
    [8, 128] f32; parameters edited in place afterwards need
    :meth:`refold`. Serving only: the forward raises in training mode, as
    the JAX module asserts ``not train``, so call ``.eval()`` first. Fixed
    geometry: rad 3, ele 7, azi 20, 16 stem channels, width 1, dim 32.

    Input [K, 16, 3, 7, 20] -> output [K, 32, 7, 20] f32, the layouts of
    :class:`CylindricalConvNet`; both are views of the kernel's
    channels-last tensors, so a channels-last caller pays no copy.
    """

    def __init__(self, dim: int = 32):
        if dim != 32:
            raise ValueError(f"the fused conv stack's last layer is fixed at "
                             f"32 channels, got dim={dim}")
        super().__init__(dim, 1.0, torch.bfloat16)
        self.register_buffer("folded_w", torch.empty(0), persistent=False)
        self.register_buffer("folded_b", torch.empty(0), persistent=False)
        self.refold()
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module.refold())

    @torch.no_grad()
    def refold(self) -> None:
        w, b = fold_cyl_stack(self.state_dict())
        dev = self.layers[0].weight.device
        self.folded_w = w.to(dev)
        self.folded_b = b.to(dev)

    def forward(self, x: torch.Tensor,
                bn_stats: dict | None = None) -> torch.Tensor:
        if self.training:
            raise RuntimeError("FusedCylindricalConvNet is serving-only: "
                               "call .eval() before the forward")
        out = cyl_conv_stack(x.permute(0, 2, 3, 4, 1), self.folded_w,
                             self.folded_b)  # [K, 7, 20, 32]
        return out.permute(0, 3, 1, 2)
