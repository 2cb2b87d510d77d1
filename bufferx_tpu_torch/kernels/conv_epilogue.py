"""The serving epilogue of the nets' conv layers: a CUDA kernel and its plain
version.

In serving bf16, :class:`~bufferx_tpu_torch.models.layers.ConvBNRelu` and its
subclasses follow every convolution (or the stems' matmul) with an eager
chain of full-size passes: the bias added in the compute dtype, BatchNorm in
float32 from the running statistics, a rounding back to the compute dtype,
the ReLU in float32, then the consumer's own passes: the next cylindrical
conv's pad (:func:`pad_cyl_2d`) and cast, or the sampled stem's max over its
samples. :func:`conv_epilogue_plain` is that chain, op for op; the kernel
(``csrc/conv_epilogue.cu``) reads the conv's output once and writes the
consumer's input in one pass, bit-equal to it (every rounding point kept, no
operation contracted). It replaces no Pallas kernel: XLA fuses the chain into
the convolution on the TPU.

The consumer's form (``out``):

- ``"f32"``: the layer's output as the eager layer returns it, float32;
- ``"bf16"``: the same in the compute dtype (the next VALID conv's input);
- ``"pad2d"``: ``pad_cyl_2d(y, 3)`` in the compute dtype, a 3D conv's
  ``rad = 1`` axis dropped (the next cylindrical conv's input); the kernel
  takes a channels-last ``y``, as the cylindrical nets run on the card;
- ``"pad3d"``: a channels-last stem output [K, G, C] as the first
  cylindrical conv's padded input ``pad_cyl_3d([K, C, rad, ele, azi], 3)``
  in the compute dtype, ``grid = (rad, ele, azi)``;
- ``"amax"``: the max over the samples of a channels-last [K, G, S, C]
  output, float32 [K, G, C] (the sampled stem).

The factored cost stem hands its two convs' outputs (``y`` = A, ``c2d``) and
the kernel makes its rolls, stack and subtraction in the same pass.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from bufferx_tpu_torch.cuda_build import CudaKernel, ptr, register

__all__ = ["CONV_EPILOGUE_KERNEL", "FORMS", "EpilogueConstants",
           "pad_cyl_2d", "pad_cyl_3d", "at_least_f32", "to_form",
           "conv_epilogue_plain", "conv_epilogue_cuda", "conv_epilogue"]

FORMS = ("f32", "bf16", "pad2d", "pad3d", "amax")
# the kernel's forms and flags (csrc/conv_epilogue.cu)
_SAME, _PAD_CL, _AMAX, _COST = range(4)
_HAS_BN, _HAS_BN_BIAS, _ROUND_BN, _RELU, _OUT_F32, _CHANNELS_LAST = (
    1, 2, 4, 8, 16, 32)

_V, _I = ctypes.c_void_p, ctypes.c_int
CONV_EPILOGUE_KERNEL = register(CudaKernel(
    "conv_epilogue", "conv_epilogue.cu", replaces=None,
    entry="bx_conv_epilogue",
    argtypes=[_V] * 7 + [_I, _I, ctypes.c_longlong, _I, _I, _I],
    functions=("same_kernel", "padcl_kernel", "amax_kernel", "cost_kernel"),
))

# Eval-mode forwards of a conv layer on the card that took the eager chain
# (a gradient needed, or a compute dtype other than bf16); the main path
# makes none.
eager_serving_forwards = 0


def count_eager_serving() -> None:
    global eager_serving_forwards
    eager_serving_forwards += 1


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


@dataclass(frozen=True)
class EpilogueConstants:
    """One layer's serving epilogue: ``bias`` [C] in the compute dtype;
    BatchNorm's running ``mean`` and ``mul = rsqrt(var + eps) (* scale)``
    [C] float32 (None without BatchNorm) and the affine ``bn_bias`` (None
    unless affine); ``round_bn``: round to the compute dtype after BatchNorm
    (the conv layers and stems do; the factored cost stem hands float32 on);
    ``relu``."""
    bias: torch.Tensor
    mean: torch.Tensor | None = None
    mul: torch.Tensor | None = None
    bn_bias: torch.Tensor | None = None
    round_bn: bool = True
    relu: bool = True


def to_form(y: torch.Tensor, out: str, dt: torch.dtype,
            grid: tuple | None = None) -> torch.Tensor:
    """The eager layer's output ``y`` (at least float32) in the consumer's
    form ``out``, ``dt`` the compute dtype (see the module notes)."""
    if out == "f32":
        return y
    if out == "bf16":
        return y.to(dt)
    if out == "pad2d":
        if y.ndim == 5:                      # a 3D conv's rad = 1 axis
            y = y[:, :, 0]
        return pad_cyl_2d(y, 3).to(dt)
    if out == "pad3d":                       # [K, G, C] channels-last
        cl = y.reshape(y.shape[0], *grid, y.shape[-1])
        return pad_cyl_3d(cl.permute(0, 4, 1, 2, 3), 3).to(dt)
    if out == "amax":                        # [K, G, S, C]
        return torch.amax(y, dim=-2)
    raise ValueError(f"unknown output form {out!r}; expected one of {FORMS}")


def conv_epilogue_plain(y: torch.Tensor, const: EpilogueConstants,
                        out: str = "f32", channel_dim: int = 1,
                        grid: tuple | None = None,
                        c2d: torch.Tensor | None = None) -> torch.Tensor:
    """The eager chain: ``y`` the conv's (or matmul's) output in the compute
    dtype, channels at ``channel_dim``; with ``c2d`` the factored cost
    stem's (``y`` its circular conv A [B, C, H, L], ``c2d`` [B, C, H, L-2]):
    ``stack_s roll(A, s)[..., :L-2] - c2d`` first. Any device."""
    dt = y.dtype
    if c2d is not None:
        w = y.shape[-1] - 2
        recon = torch.stack([torch.roll(y, s, dims=3)[..., :w]
                             for s in range(w)], dim=2)
        y = recon - c2d[:, :, None]
        channel_dim = 1
    shape = [1] * y.ndim
    shape[channel_dim] = -1
    y = y + const.bias.view(shape)
    if const.mean is not None:
        y = (at_least_f32(y) - const.mean.view(shape)) * const.mul.view(shape)
        if const.bn_bias is not None:
            y = y + const.bn_bias.view(shape)
        if const.round_bn:
            y = y.to(dt)
    y = at_least_f32(y)
    if const.relu:
        y = torch.relu(y)
    return to_form(y, out, dt, grid)


def _layout(t: torch.Tensor) -> str | None:
    """"c" (dense, row-major), "cl" (dense channels-last, 4-D or 5-D) or
    None."""
    if t.is_contiguous():
        return "c"
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}.get(t.ndim)
    if fmt is not None and t.is_contiguous(memory_format=fmt):
        return "cl"
    return None


def _plan(y: torch.Tensor, const: EpilogueConstants, out: str,
          channel_dim: int, grid: tuple | None, c2d: torch.Tensor | None):
    """The launch of :func:`conv_epilogue_cuda` without the device: checks
    the dtypes, layouts and shapes, and allocates the output on ``y``'s
    device in the layout the eager chain gives it. Returns (the output,
    form code, flags, n, C, d0, d1)."""
    if out not in FORMS:
        raise ValueError(f"unknown output form {out!r}; expected one of "
                         f"{FORMS}")
    consts = (const.mean, const.mul, const.bn_bias)
    for t, dtype, name in ((y, torch.bfloat16, "input"),
                           (c2d, torch.bfloat16, "c2d"),
                           (const.bias, torch.bfloat16, "bias"),
                           *zip(consts, [torch.float32] * 3,
                                ("mean", "mul", "bn_bias"))):
        if t is None:
            continue
        if t.dtype != dtype:
            raise ValueError(f"conv epilogue {name}: expected {dtype}, got "
                             f"{t.dtype}")
        if _layout(t) is None or (t is not y and not t.is_contiguous()):
            raise ValueError(f"conv epilogue {name}: expected a contiguous "
                             "(or, for the input, channels-last) tensor")
    if (const.mean is None) != (const.mul is None) or (
            const.bn_bias is not None and const.mean is None):
        raise ValueError("conv epilogue: mean and mul come together, and "
                         "bn_bias only with them")
    flags = ((_HAS_BN if const.mean is not None else 0)
             | (_HAS_BN_BIAS if const.bn_bias is not None else 0)
             | (_ROUND_BN if const.round_bn else 0)
             | (_RELU if const.relu else 0)
             | (_OUT_F32 if out in ("f32", "amax") else 0))
    out_dtype = torch.float32 if flags & _OUT_F32 else torch.bfloat16
    cd = channel_dim % y.ndim
    c_n = y.shape[cd]
    layout = _layout(y)
    if c_n != const.bias.numel() or any(
            t is not None and t.numel() != c_n for t in consts):
        raise ValueError(f"conv epilogue: {c_n} channels against constants "
                         f"of {const.bias.numel()}")

    def empty(shape, fmt=torch.contiguous_format):
        return torch.empty(shape, dtype=out_dtype, device=y.device,
                           memory_format=fmt)

    if c2d is not None:                        # the factored cost stem
        if out not in ("f32", "bf16") or y.ndim != 4 or cd != 1 \
                or layout != "c":
            raise ValueError("conv epilogue: the cost stem takes a contiguous "
                             "A [B, C, H, L] and gives 'f32' or 'bf16'")
        b, _, h, length = y.shape
        w = length - 2
        if tuple(c2d.shape) != (b, c_n, h, w) or length < 4 or length % 2:
            raise ValueError(f"conv epilogue: A {tuple(y.shape)} and C2d "
                             f"{tuple(c2d.shape)} do not pair")
        return empty((b, c_n, w, h, w)), _COST, flags, b, c_n, h, length
    if out in ("f32", "bf16"):
        if cd == 1 and layout == "c":          # [N, C, ...]
            return (empty(y.shape), _SAME, flags, y.shape[0], c_n,
                    math.prod(y.shape[2:]), 0)
        if (cd == y.ndim - 1 and layout == "c") or (cd == 1
                                                     and layout == "cl"):
            # channels innermost: rows of C, the eager chain's own strides
            return (torch.empty_like(y, dtype=out_dtype), _SAME,
                    flags | _CHANNELS_LAST, y.numel() // max(c_n, 1), c_n, 1,
                    0)
        raise ValueError("conv epilogue: channels first (dim 1) or innermost")
    if out == "pad2d":
        if cd != 1 or y.ndim not in (4, 5) or (y.ndim == 5
                                               and y.shape[2] != 1):
            raise ValueError(f"conv epilogue 'pad2d': [K, C, ele, azi] or [K, "
                             f"C, 1, ele, azi], got {tuple(y.shape)}")
        n, ele, azi = y.shape[0], y.shape[-2], y.shape[-1]
        if layout != "cl" or c_n % 2:
            raise ValueError("conv epilogue 'pad2d': a channels-last input "
                             "with an even channel count")
        return (empty((n, c_n, ele + 2, azi + 2), torch.channels_last),
                _PAD_CL, flags, n, c_n, ele, azi)
    if out == "pad3d":                         # the stem's [K, G, C]
        rad, ele, azi = grid
        if y.ndim != 3 or cd != 2 or y.shape[1] != rad * ele * azi \
                or c_n % 2:
            raise ValueError(f"conv epilogue 'pad3d': [K, {rad * ele * azi}, "
                             f"C] with C even, got {tuple(y.shape)}")
        n = y.shape[0]
        return (empty((n, c_n, rad, ele + 2, azi + 2), torch.channels_last_3d),
                _PAD_CL, flags, n * rad, c_n, ele, azi)
    if y.ndim != 4 or cd != 3 or c_n % 2:      # amax over [K, G, S, C]
        raise ValueError(f"conv epilogue 'amax': [K, G, S, C] with C even, "
                         f"got {tuple(y.shape)}")
    return (empty((y.shape[0], y.shape[1], c_n)), _AMAX, flags,
            y.shape[0] * y.shape[1], c_n, y.shape[2], 0)


def conv_epilogue_cuda(y: torch.Tensor, const: EpilogueConstants,
                       out: str = "f32", channel_dim: int = 1,
                       grid: tuple | None = None,
                       c2d: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel; the contract of :func:`conv_epilogue_plain` for a bf16
    ``y`` (contiguous, or channels-last where the conv runs so), in the
    plain version's layout. Raises on another dtype, another layout, a
    tensor off the card and shapes the form does not take."""
    res, form, flags, n, c_n, d0, d1 = _plan(y, const, out, channel_dim,
                                             grid, c2d)
    tensors = [t for t in (y, c2d, const.bias, const.mean, const.mul,
                           const.bn_bias) if t is not None]
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"conv epilogue: expected CUDA tensors, got "
                             f"{t.device}")
        if t.data_ptr() % 4:
            raise ValueError("conv epilogue: expected 4-byte alignment")
    if res.numel():
        none = ctypes.c_void_p(0)
        CONV_EPILOGUE_KERNEL.launch(
            *(ptr(t) if t is not None else none
              for t in (y, c2d, const.bias, const.mean, const.mul,
                        const.bn_bias)),
            ptr(res), form, flags, n, c_n, d0, d1)
    return res


def conv_epilogue(y: torch.Tensor, const: EpilogueConstants,
                  out: str = "f32", channel_dim: int = 1,
                  grid: tuple | None = None,
                  c2d: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatch: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if y.is_cuda:
        return conv_epilogue_cuda(y, const, out, channel_dim, grid, c2d)
    if y.device.type == "cpu":
        return conv_epilogue_plain(y, const, out, channel_dim, grid, c2d)
    raise ValueError(f"conv_epilogue: unsupported device {y.device}")
