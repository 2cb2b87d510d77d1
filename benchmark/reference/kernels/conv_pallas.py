"""Fused 8-layer cylindrical conv stack, plain PyTorch (frozen copy of the
port's K5 plain version).

Counterpart of :mod:`bufferx_tpu.kernels.conv_pallas` (same module name):
the serving form of :class:`benchmark.reference.models.layers.CylindricalConvNet`
with inference BatchNorm folded into the conv weights
(:func:`fold_cyl_stack`, once per model). The first 3x3x3 conv collapses
the radial axis, so it is a 3x3 conv over ``3 * 16 = 48`` input channels in
the order ``dr * 16 + m``. Every layer is a 3x3 conv that wraps azimuth and
zero-pads elevation; bias is added in f32, every layer but the last is
followed by a ReLU, and activations round to bf16 between layers (products
of bf16 values, f32 accumulation). The output is the last layer's bf16
value as f32, ``[K, ele=7, azi=20, 32]``.

:func:`cyl_conv_stack_plain` mirrors the JAX package's
``cyl_conv_stack_reference`` with the same rounding points; the kernel sums
in another order, so a bf16 rounding step can flip between the two.

The kernel reads its weights in the byte order its shared-memory tiles
want (:func:`pack_cyl_weights`, a pure permutation of the fold's real
entries); :class:`~benchmark.reference.models.layers.FusedCylindricalConvNet`
packs once where it folds and hands the packed tensor in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


__all__ = [
        "CYL_LAYER_CHANNELS",
    "fold_cyl_stack",
    "cyl_conv_stack_plain",
        "cyl_conv_stack",
]

_ELE, _AZI, _LANES = 7, 20, 128
# (ci, co) per layer after folding layer 0's radial axis into channels
CYL_LAYER_CHANNELS = (
    (48, 64), (64, 64), (64, 128), (128, 128),
    (128, 64), (64, 64), (64, 32), (32, 32),
)
_W_OFFSETS = []
_off = 0
for _ci, _co in CYL_LAYER_CHANNELS:
    _W_OFFSETS.append(_off)
    _off += 9 * _ci
_W_ROWS = _off                       # 5328
_DIM = CYL_LAYER_CHANNELS[-1][1]     # the last layer is fixed at 32

def fold_cyl_stack(state: dict, eps: float = 1e-5):
    """Fold inference BN into the conv weights and pack them for the stack.

    ``state``: a :class:`CylindricalConvNet` state dict (``layers.{i}.weight``
    OIDHW for layer 0, OIHW after; ``bias``; ``bn_mean``/``bn_var`` for all
    but the last layer). Returns ``(w [5328, 128] bf16, b [8, 128] f32)``:
    layer ``i``'s rows start at its offset, ordered ``(de, da, c)``, with
    output channels zero-padded to 128 lanes.
    """
    w_all = torch.zeros((_W_ROWS, _LANES), dtype=torch.float32)
    b_all = torch.zeros((len(CYL_LAYER_CHANNELS), _LANES), dtype=torch.float32)
    for i, (ci, co) in enumerate(CYL_LAYER_CHANNELS):
        kernel = state[f"layers.{i}.weight"].detach().to("cpu", torch.float32)
        bias = state[f"layers.{i}.bias"].detach().to("cpu", torch.float32)
        if i == 0:
            # [co, m, dr, de, da] -> [de, da, dr, m, co]: channel dr*16 + m
            kernel = kernel.permute(3, 4, 2, 1, 0)
        else:
            kernel = kernel.permute(2, 3, 1, 0)             # [de, da, ci, co]
        k3 = kernel.reshape(3, 3 * ci, co)
        if i < len(CYL_LAYER_CHANNELS) - 1:
            mean = state[f"layers.{i}.bn_mean"].detach().to("cpu", torch.float32)
            var = state[f"layers.{i}.bn_var"].detach().to("cpu", torch.float32)
            s = torch.rsqrt(var + eps)
            k3 = k3 * s
            bias = (bias - mean) * s
        off = _W_OFFSETS[i]
        w_all[off:off + 9 * ci, :co] = k3.reshape(9 * ci, co)
        b_all[i, :co] = bias
    return w_all.to(torch.bfloat16), b_all


def _check_input(x: torch.Tensor) -> None:
    if tuple(x.shape[1:]) != (3, _ELE, _AZI, 16):
        raise ValueError(f"conv stack expects [K, 3, 7, 20, 16], got "
                         f"{tuple(x.shape)}")


def cyl_conv_stack_plain(x, w, b) -> torch.Tensor:
    """x [K, 3, 7, 20, 16] -> [K, 7, 20, 32] f32, with the
    JAX reference's layout and rounding points (bf16 products summed in
    f32 per elevation tap)."""
    _check_input(x)
    k = x.shape[0]
    cur = x.permute(0, 2, 3, 1, 4).reshape(k, _ELE, _AZI, 48).to(torch.bfloat16)
    for i, (ci, co) in enumerate(CYL_LAYER_CHANNELS):
        off = _W_OFFSETS[i]
        wi = w[off:off + 9 * ci, :co].to(torch.float32).reshape(3, 3 * ci, co)
        x3 = torch.cat([torch.roll(cur, 1, dims=2), cur,
                        torch.roll(cur, -1, dims=2)], dim=-1)
        x3 = F.pad(x3.to(torch.float32), (0, 0, 0, 0, 1, 1))  # elevation
        y = torch.zeros((k, _ELE, _AZI, co), dtype=torch.float32,
                        device=x.device)
        for de in range(3):
            y = y + torch.matmul(x3[:, de:de + _ELE], wi[de])
        y = y + b[i, :co]
        if i < len(CYL_LAYER_CHANNELS) - 1:
            y = torch.relu(y)
        cur = y.to(torch.bfloat16)
    return cur.to(torch.float32)


def cyl_conv_stack(x, w, b) -> torch.Tensor:
    """The plain stack on any device."""
    return cyl_conv_stack_plain(x, w, b)
