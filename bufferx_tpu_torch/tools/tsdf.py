"""TSDF volume fusion (offline fragment generation).

The port's counterpart of :mod:`bufferx_tpu.tools.tsdf`, itself the
replacement for the reference's CUDA ``Integrate`` kernel
(``dataset/scannetpp/iphone/scannetpp.cu:24-120``): project every voxel
center into each depth frame, compute the truncated signed distance along
the camera ray, and fold it into a weighted running average. The volume
lives on one device (the card by default) for the whole fusion: a frame
copies over only its depth image (192 x 256 float32 for the iPhone), and
nothing comes back until :func:`extract_points`.

The arithmetic is the JAX function's as XLA compiles it for the CPU,
operation by operation and rounding by rounding, in float32. Where XLA
contracts a multiply and an add into one fused multiply-add (voxel centres
``origin + voxel_size * index``; the running average's ``tsdf * weight +
dist``), the port takes the product and the sum in float64 and rounds once
to float32: the product of two float32 values is exact in float64 and, at
these magnitudes, so is the sum, so the one rounding is the fused
operation's. Camera coordinates ``R^T (p - t)`` are summed in the order
``(p_x - t_x) R_0j``, ``(p_y - t_y) R_1j``, ``(p_z - t_z) R_2j``: x and y
with each product and sum rounded, z with fused multiply-adds, as XLA's
CPU dot sums a ``[N, 3] x [3, 3]`` product. A voxel's offset along one
axis depends on one grid index, so the offsets and their products are
taken on the axis vectors and broadcast (the same floats at a third of the
traffic). Pixels are ``round(f x / z + c)``, rounded half to even. Whether
a projection lands inside the image is decided on the rounded float,
before any integer cast: an out-of-range float's cast is not defined alike
on every backend. Every division has a tensor divisor: PyTorch divides a
CUDA tensor by a Python scalar as a product with its reciprocal. On the
card every one of these operations rounds as on the CPU, so a card volume
equals a CPU volume to the bit.

These are plain PyTorch operations and no hand-written kernel: the JAX
module is plain ``jnp`` code and reaches no Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bufferx_tpu_torch.device import constant, resolve_device

__all__ = ["TsdfVolume", "make_volume", "reset_volume", "integrate_frame",
           "extract_points"]

_MAX_DEPTH = 6.0  # reference's depth validity cap (scannetpp.cu:60)


class TsdfVolume(NamedTuple):
    tsdf: torch.Tensor     # [X, Y, Z] f32, init 1.0
    weight: torch.Tensor   # [X, Y, Z] f32, init 0.0
    origin: torch.Tensor   # [3] f32
    voxel_size: float
    trunc: float


def make_volume(origin, dims, voxel_size: float, trunc: float | None = None,
                device="cuda") -> TsdfVolume:
    """An empty volume of ``dims`` voxels on ``device`` (the card unless the
    caller asks for the CPU); truncation defaults to 5 voxels."""
    dev = resolve_device(device)
    dims = tuple(int(d) for d in dims)
    return TsdfVolume(
        tsdf=torch.ones(dims, dtype=torch.float32, device=dev),
        weight=torch.zeros(dims, dtype=torch.float32, device=dev),
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=dev),
        voxel_size=float(voxel_size),
        trunc=float(trunc if trunc is not None else 5 * voxel_size),
    )


def reset_volume(vol: TsdfVolume) -> TsdfVolume:
    """Empties ``vol`` in place (tsdf 1, weight 0) for the next fragment."""
    vol.tsdf.fill_(1.0)
    vol.weight.fill_(0.0)
    return vol


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in either)."""
    return float(np.float32(x))


def integrate_frame(vol: TsdfVolume, cam_k, cam2base, depth) -> TsdfVolume:
    """Folds one depth frame into the volume, in place on its device, and
    returns it.

    cam_k: [3,3] intrinsics; cam2base: [4,4] camera-to-base pose;
    depth: [H, W] meters (0 = invalid), numpy or a tensor."""
    dev = vol.tsdf.device
    nx, ny, nz = vol.tsdf.shape
    k = np.asarray(cam_k, np.float32)
    pose = np.asarray(cam2base, np.float32)
    vs = _f32(vol.voxel_size)
    trunc = _f32(vol.trunc)
    depth = torch.as_tensor(depth, dtype=torch.float32).to(dev)
    h, w = depth.shape

    # base -> camera, R^T (p - t), on the axis vectors (scannetpp.cu:40-46)
    offs = []
    for axis, n in enumerate((nx, ny, nz)):
        g = torch.arange(n, dtype=torch.float64, device=dev)
        centre = g.mul_(vs).add_(vol.origin[axis].double()).float()
        offs.append(centre.sub_(float(pose[axis, 3])))
    ax, ay, az = offs

    def cam(j):
        xy = (ax * float(pose[0, j]))[:, None, None] \
            + (ay * float(pose[1, j]))[None, :, None]
        return xy + (az * float(pose[2, j]))[None, None, :]

    def cam_fused(j):
        acc = (ax * float(pose[0, j])).double()[:, None, None]
        acc = (ay.double() * float(pose[1, j]))[None, :, None].add(acc)
        acc = acc.float().double()
        return (az.double() * float(pose[2, j]))[None, None, :].add(acc) \
            .float()

    zc = cam_fused(2)
    u = cam(0).mul_(float(k[0, 0])).div_(zc).add_(float(k[0, 2])).round_()
    v = cam(1).mul_(float(k[1, 1])).div_(zc).add_(float(k[1, 2])).round_()
    in_img = (zc > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    flat = v.mul_(w).add_(u)              # exact: v w + u < 2^24
    del u
    flat = torch.where(in_img, flat, 0.0).to(torch.int32)
    d = depth.reshape(-1)[flat]
    del flat, v
    valid = in_img & (d > 0) & (d <= _MAX_DEPTH)
    diff = d.sub_(zc)
    del zc
    valid &= diff > -trunc
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the division's rounding
    dist = diff.div_(constant((trunc,), torch.float32, dev)).clamp_(-1.0, 1.0)

    num = vol.tsdf.double().mul_(vol.weight).add_(dist).float()
    del dist
    vol.weight.add_(valid)        # w + 0 = w where the voxel is not updated
    num.div_(vol.weight.clamp_min(1.0))
    torch.where(valid, num, vol.tsdf, out=vol.tsdf)
    return vol


def extract_points(vol: TsdfVolume, band: float = 0.2) -> np.ndarray:
    """Near-surface voxel centers -> [N, 3] float32 (host), in
    ``np.argwhere`` (row-major) order."""
    mask = (vol.tsdf.abs() < band) & (vol.weight > 0)
    idx = torch.nonzero(mask).cpu().numpy()
    origin = vol.origin.to("cpu", torch.float32).numpy()
    return (origin[None] + vol.voxel_size * idx).astype(np.float32)
