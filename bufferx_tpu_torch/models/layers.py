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

Each layer hands its consumer the form it reads (``out``: "f32", "bf16",
"pad2d", and for the stems "pad3d" and "amax"; the forms are those of
:mod:`bufferx_tpu_torch.kernels.conv_epilogue`): a cylindrical layer writes
the next one's padded input, a cost-net layer the next one's bf16 input. In
serving on the card (a CUDA input, eval mode, no gradient needed, bf16
compute) one kernel applies the whole epilogue and writes that form; anywhere
else the eager chain runs, op for op as before, and its output is put in the
same form by the same ops that the consumer used to apply. Both give the same
bits. An eval-mode forward on the card that takes the eager chain (a gradient
needed, or another compute dtype) is counted
(``conv_epilogue.eager_serving_forwards``). The bf16
weights and the epilogue's per-channel constants are made once per state of
the layer's parameters and buffers (:meth:`ConvBNRelu.serving_state`).

In training mode (``module.train()``, the JAX layers' ``train=True``)
BatchNorm normalizes with the batch's statistics in float32, as flax's
``BatchNorm`` with ``use_fast_variance=True`` computes them: the mean and
the biased variance ``mean(x^2) - mean(x)^2`` clamped at 0, over every axis
but the channels. The forward does not touch the running statistics: it
records the batch's (mean, var) in the ``bn_stats`` dict it is given, keyed
by the layer, and :func:`running_stats` folds them into new running
statistics (``0.9 old + 0.1 batch``) for the caller to store.

With a ``bn_group`` (a :class:`~bufferx_tpu_torch.parallel.mesh.Mesh`, the
counterpart of the JAX layers' ``bn_axis_name``) the training statistics
are shared by the group's ranks, as flax's ``BatchNorm(axis_name=...)``
shares them: each rank's (mean, mean of squares) is averaged over the
ranks before the variance is formed, and the gradient flows back through
that average to every rank.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bufferx_tpu_torch.kernels.conv_epilogue import (
    EpilogueConstants,
    at_least_f32,
    conv_epilogue,
    count_eager_serving,
    pad_cyl_2d,
    pad_cyl_3d,
    to_form,
)
from bufferx_tpu_torch.kernels.conv_pallas import (
    cyl_conv_stack,
    fold_cyl_stack,
    pack_cyl_weights,
)

__all__ = ["pad_cyl_2d", "pad_cyl_3d", "ConvBNRelu", "CylindricalConvNet",
           "FusedCylindricalConvNet", "CylindricalUNet", "at_least_f32",
           "batch_norm", "batch_moments", "running_stats"]

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def bn_multiplier(var: torch.Tensor, scale=None) -> torch.Tensor:
    """BatchNorm's per-channel factor ``rsqrt(var + eps) (* scale)``."""
    mul = torch.rsqrt(var + BN_EPS)
    return mul if scale is None else mul * scale


def batch_norm(x: torch.Tensor, mean, var, scale=None, bias=None,
               channel_dim: int = 1) -> torch.Tensor:
    """BatchNorm from given statistics in (at least) float32, flax's order
    of operations."""
    shape = [1] * x.ndim
    shape[channel_dim] = -1
    mul = bn_multiplier(var, scale)
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


def running_stats(model: nn.Module, bn_stats: dict,
                  momentum: float = BN_MOMENTUM) -> dict:
    """New running statistics of ``model``'s BatchNorm layers from the batch
    statistics a training forward recorded in ``bn_stats``: ``{buffer name:
    momentum * old + (1 - momentum) * batch}`` for every ``bn_mean`` and
    ``bn_var`` of a layer in ``bn_stats`` (detached), from the buffers as
    they are."""
    out = {}
    for name, mod in model.named_modules():
        if mod not in bn_stats:
            continue
        prefix = f"{name}." if name else ""
        for buf, batch in zip(("bn_mean", "bn_var"), bn_stats[mod]):
            old = getattr(mod, buf)
            out[prefix + buf] = momentum * old + (1 - momentum) * batch.detach()
    return out


class ConvBNRelu(nn.Module):
    """VALID conv + optional BatchNorm + optional ReLU.

    ``weight`` is [out, in, *kernel]; BatchNorm keeps its running
    statistics in the buffers ``bn_mean``/``bn_var`` and, when affine,
    ``bn_scale``/``bn_bias``. In training mode BatchNorm uses the batch's
    statistics, shared over ``bn_group``'s ranks when it is set, and records
    them in ``bn_stats`` (see the module notes). ``out`` is the consumer's
    form."""

    # round to the compute dtype after BatchNorm in serving (the factored
    # cost stem hands float32 on)
    serving_rounds_bn = True

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
        self._serving = None

    def conv_weights(self) -> tuple:
        """The weights the layer's conv runs with, in the compute dtype."""
        return (self.weight.to(self.compute_dtype),)

    def serving_state(self) -> tuple:
        """(:meth:`conv_weights`, :class:`EpilogueConstants`) for the serving
        kernel: the bias in the compute dtype, BatchNorm's running mean, its
        ``mul`` by :func:`batch_norm`'s own ops and the affine bias. Made once
        per state: a parameter or buffer that is replaced or edited in place
        (``load_state_dict`` copies in place) makes them anew; an edit through
        ``.data`` bypasses the version counter and is not seen."""
        state = [*self._parameters.values(), *self._buffers.values()]
        key = [(id(t), t.data_ptr(), t._version) for t in state]
        if self._serving is None or self._serving[0] != key:
            with torch.no_grad():
                const = EpilogueConstants(
                    self.bias.to(self.compute_dtype), relu=self.use_relu,
                    round_bn=self.serving_rounds_bn)
                if self.use_bn:
                    affine = self.bn_affine
                    const = replace(
                        const, mean=self.bn_mean.detach(),
                        mul=bn_multiplier(self.bn_var,
                                          self.bn_scale if affine else None),
                        bn_bias=self.bn_bias.detach() if affine else None)
                self._serving = (key, self.conv_weights(), const)
        return self._serving[1:]

    def kernel_serves(self, *xs: torch.Tensor) -> bool:
        """Whether the serving kernel runs this forward on inputs ``xs``: on
        the card, in eval mode, with no gradient needed, in bf16. An
        eval-mode forward on the card that it does not run is counted."""
        if not _on_card(xs[0]) or self.training:
            return False
        if self.compute_dtype != torch.bfloat16 or (
                torch.is_grad_enabled() and any(
                    t.requires_grad
                    for t in (*xs, *self._parameters.values()))):
            count_eager_serving()
            return False
        return True

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

    def forward(self, x: torch.Tensor, bn_stats: dict | None = None,
                out: str = "f32") -> torch.Tensor:
        dt = self.compute_dtype
        conv = F.conv2d if len(self.kernel) == 2 else F.conv3d
        if self.kernel_serves(x):
            (w,), const = self.serving_state()
            return conv_epilogue(conv(x.to(dt), w), const, out)
        (w,) = self.conv_weights()
        y = conv(x.to(dt), w)
        y = y + self.bias.to(dt).view((1, -1) + (1,) * len(self.kernel))
        if self.use_bn:
            y = self.norm(y, bn_stats)
            if not self.training:     # serving keeps the compute dtype
                y = y.to(dt)
        y = at_least_f32(y)
        return to_form(torch.relu(y) if self.use_relu else y, out, dt)


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

    def forward(self, x: torch.Tensor, bn_stats: dict | None = None,
                padded: bool = False) -> torch.Tensor:
        """``padded``: ``x`` is already layer 0's input, ``pad_cyl_3d(x, 3)``
        in the compute dtype (a stem's "pad3d" form). Each layer writes the
        next one's padded input; layer 0 collapses rad 3 -> 1. On the card
        the layers run channels-last, the layout the serving kernel pads."""
        if not padded:
            x = pad_cyl_3d(x, 3)
            if _on_card(x):
                x = x.contiguous(memory_format=torch.channels_last_3d)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x, bn_stats, out="f32" if i == last else "pad2d")
        return x


class FusedCylindricalConvNet(CylindricalConvNet):
    """Inference form of :class:`CylindricalConvNet` as ONE fused program
    (kernel K5, ``kernels/conv_pallas.py``), BatchNorm folded into the
    weights. Counterpart of :class:`bufferx_tpu.models.layers.
    FusedCylindricalConvNet`.

    Parameter and buffer names are those of the bf16 ``CylindricalConvNet``,
    so the same state dicts load with ``strict=True``. The fold runs once,
    when the module is built and after every ``load_state_dict``, into the
    non-persistent buffers ``folded_w`` [5328, 128] bf16, ``folded_b``
    [8, 128] f32 and ``packed_w`` (``folded_w`` in the kernel's tile order,
    :func:`pack_cyl_weights`); parameters edited in place afterwards need
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
        self.register_buffer("packed_w", torch.empty(0), persistent=False)
        self.refold()
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module.refold())

    @torch.no_grad()
    def refold(self) -> None:
        w, b = fold_cyl_stack(self.state_dict())
        dev = self.layers[0].weight.device
        self.folded_w = w.to(dev)
        self.folded_b = b.to(dev)
        self.packed_w = pack_cyl_weights(self.folded_w)

    def forward(self, x: torch.Tensor,
                bn_stats: dict | None = None) -> torch.Tensor:
        if self.training:
            raise RuntimeError("FusedCylindricalConvNet is serving-only: "
                               "call .eval() before the forward")
        out = cyl_conv_stack(x.permute(0, 2, 3, 4, 1), self.folded_w,
                             self.folded_b, self.packed_w)  # [K, 7, 20, 32]
        return out.permute(0, 3, 1, 2)


class CylindricalUNet(nn.Module):
    """U-Net form of the backbone (reference ``Cylindrical_UNet``,
    ``models/patchnet.py:86-149``; counterpart of
    :class:`bufferx_tpu.models.layers.CylindricalUNet`, which no pipeline
    uses): a 3x3x3 stem collapsing the radial axis, a 3-level encoder (32,
    64, 128 channels), a 128-channel bottleneck and a decoder whose skips
    concatenate ``[deeper, encoder]`` on the channels, all cylindrically
    padded, every layer with affine BatchNorm and ReLU.

    flax infers the input width; here it is ``in_features`` (16, the
    descriptor stem's width, by default). Input [K, in_features, rad=3, ele,
    azi] -> ``(out [K, dim, ele, azi] f32, None)``, the JAX module's pair.
    Training mode records BatchNorm statistics in ``bn_stats`` and shares
    them over ``bn_group``, as :class:`ConvBNRelu` does."""

    def __init__(self, in_features: int = 16, dim: int = 32,
                 compute_dtype: torch.dtype = torch.float32, bn_group=None):
        super().__init__()

        def block(cin, cout, kernel=(3, 3)):
            return ConvBNRelu(cin, cout, kernel, bn_affine=True,
                              compute_dtype=compute_dtype, bn_group=bn_group)

        self.stem = block(in_features, 32, (3, 3, 3))
        self.enc1 = block(32, 32)
        self.enc2 = block(32, 64)
        self.enc3 = block(64, 128)
        self.bott = block(128, 128)
        self.dec3 = block(128 + 128, 64)
        self.dec2 = block(64 + 64, 32)
        self.dec1 = block(32 + 32, 32)
        self.final = block(32, dim)

    def forward(self, x: torch.Tensor, bn_stats: dict | None = None):
        def conv(layer, *xs):
            x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)
            return layer(pad_cyl_2d(x, 3), bn_stats)

        x = self.stem(pad_cyl_3d(x, 3), bn_stats)[:, :, 0]   # rad 3 -> 1
        enc1 = conv(self.enc1, x)
        enc2 = conv(self.enc2, enc1)
        enc3 = conv(self.enc3, enc2)
        bott = conv(self.bott, enc3)
        dec3 = conv(self.dec3, bott, enc3)
        dec2 = conv(self.dec2, dec3, enc2)
        dec1 = conv(self.dec1, dec2, enc1)
        return conv(self.final, dec1), None
