"""Reference-checkpoint importer: BUFFER-X ``.pth`` -> the port's snapshots.

The port's counterpart of :mod:`bufferx_tpu.tools.torch_import`. The
reference ships trained checkpoints per stage (``snapshot/<exp>/{Desc,Pose}/
best.pth``: the ``state_dict`` of the whole ``BufferX`` module, loaded with
the stage-filtered merge of the reference's ``test.py:87-94``). This module
maps those tensors into the flax variable trees that both packages'
snapshots hold (``{Desc,Pose}/best.msgpack``), which
:func:`bufferx_tpu_torch.tools.weights.load_snapshot` then serves.

Layout facts the mapping encodes (reference files cited per function):

- ``Desc.pnt_layer``  = Conv2d(3->16,1x1)+BN(affine)+ReLU
  (``models/patch_embedder.py:26-30``)        -> desc ``ConvBNRelu_0``
- ``Desc.conv_net``   = Cylindrical_Net ops list: Conv3d(16->64,3^3) then
  seven Conv2d 3x3, BNs affine-free, last conv bare
  (``models/patchnet.py:68-84``)              -> desc ``CylindricalConvNet_0``
- ``Desc.pool_layer`` = Conv2d(32->16)+BN+ReLU, Conv2d(16->1)+BN+ReLU
  (``models/patch_embedder.py:32-39``)        -> desc ``ConvBNRelu_1/2``
- ``Pose.conv``       = CostNet: ten Conv3d, BNs affine-free, last bare
  (``models/patchnet.py:192-210``)            -> pose ``ConvBNRelu_0..9``

Tensor layout conversion: torch Conv2d ``[out,in,kh,kw]`` -> flax
``[kh,kw,in,out]``; Conv3d ``[out,in,kd,kh,kw]`` -> ``[kd,kh,kw,in,out]``;
BatchNorm weight/bias -> scale/bias, running_mean/var -> batch_stats.

The port always has PyTorch, so :func:`load_state_dict` is
``torch.load(weights_only=True)`` (the JAX module also carries a torch-free
parser for hosts without it). The trees are written with the port's msgpack
writer in the JAX importer's key order, so both importers write the same
bytes for the same ``.pth``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bufferx_tpu_torch.tools.weights import msgpack_dumps

__all__ = [
    "load_state_dict",
    "desc_variables_from_reference",
    "pose_variables_from_reference",
    "import_reference_snapshot",
]


def load_state_dict(path: str) -> dict:
    """``.pth`` -> {key: np.ndarray} (host). bfloat16 tensors are widened to
    float32 (exactly: numpy has no bfloat16)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                v = v.float()
            v = v.numpy()
        out[k] = v
    return out


def _conv2d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv3d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def _cbr(sd, conv_key, bn_key, conv_fn, affine):
    """(params, batch_stats) subtrees for one ConvBNRelu from torch keys."""
    params = {
        "Conv_0": {
            "kernel": conv_fn(sd[conv_key + ".weight"]),
            "bias": sd[conv_key + ".bias"],
        }
    }
    stats = {}
    if bn_key is not None:
        bn_p = {}
        if affine:
            bn_p = {"scale": sd[bn_key + ".weight"],
                    "bias": sd[bn_key + ".bias"]}
        if bn_p:
            params["BatchNorm_0"] = bn_p
        stats["BatchNorm_0"] = {
            "mean": sd[bn_key + ".running_mean"],
            "var": sd[bn_key + ".running_var"],
        }
    return params, stats


def desc_variables_from_reference(sd: dict, prefix: str = "Desc.") -> dict:
    """MiniSpinNet (sampled mode) state_dict subtree -> flax variables.

    The moments descriptor mode has a different (10-channel) input layer
    and a differently-trained descriptor space: reference weights only
    map onto ``desc_mode="sampled"``.
    """
    p = prefix
    params: dict = {}
    stats: dict = {}

    def put(name, pair):
        sub_p, sub_s = pair
        params[name] = sub_p
        if sub_s:
            stats[name] = sub_s

    put("ConvBNRelu_0", _cbr(sd, p + "pnt_layer.0", p + "pnt_layer.1",
                             _conv2d, affine=True))
    # conv_net ops: (Conv, BN, ReLU) triplets; the 3x3x3 stem is ops.0/1,
    # the bare last conv is ops.21 (models/patchnet.py:68-84)
    net_p: dict = {}
    net_s: dict = {}
    op = 0
    for i in range(8):
        conv_fn = _conv3d if i == 0 else _conv2d
        has_bn = i < 7
        sub_p, sub_s = _cbr(
            sd, f"{p}conv_net.ops.{op}",
            f"{p}conv_net.ops.{op + 1}" if has_bn else None,
            conv_fn, affine=False,
        )
        net_p[f"ConvBNRelu_{i}"] = sub_p
        if sub_s:
            net_s[f"ConvBNRelu_{i}"] = sub_s
        op += 3 if has_bn else 1
    params["CylindricalConvNet_0"] = net_p
    stats["CylindricalConvNet_0"] = net_s

    put("ConvBNRelu_1", _cbr(sd, p + "pool_layer.0", p + "pool_layer.1",
                             _conv2d, affine=True))
    put("ConvBNRelu_2", _cbr(sd, p + "pool_layer.3", p + "pool_layer.4",
                             _conv2d, affine=True))
    return {"params": params, "batch_stats": stats}


def pose_variables_from_reference(sd: dict, prefix: str = "Pose.") -> dict:
    """CostVolume (CostNet conv stack) state_dict subtree -> flax variables."""
    p = prefix
    params: dict = {}
    stats: dict = {}
    op = 0
    for i in range(10):
        has_bn = i < 9
        sub_p, sub_s = _cbr(
            sd, f"{p}conv.ops.{op}",
            f"{p}conv.ops.{op + 1}" if has_bn else None,
            _conv3d, affine=False,
        )
        params[f"ConvBNRelu_{i}"] = sub_p
        if sub_s:
            stats[f"ConvBNRelu_{i}"] = sub_s
        op += 3 if has_bn else 1
    return {"params": params, "batch_stats": stats}


def _check_tree(got: dict, template: dict, path: str = "") -> None:
    """Shape-check the mapped tree against a freshly initialized one."""
    for k, v in template.items():
        sub = path + "/" + k
        if k not in got:
            raise KeyError(f"imported tree is missing {sub}")
        if isinstance(v, dict):
            _check_tree(got[k], v, sub)
        else:
            gshape = tuple(np.shape(got[k]))
            if gshape != tuple(v.shape):
                raise ValueError(
                    f"shape mismatch at {sub}: imported {gshape}, "
                    f"model expects {tuple(v.shape)}"
                )


def import_reference_snapshot(
    src_dir: str,
    out_dir: str,
    template: dict,
) -> dict:
    """``<src>/{Desc,Pose}/best.pth`` -> ``<out>/{Desc,Pose}/best.msgpack``.

    Applies the reference's stage-filtered merge semantics
    (``test.py:87-94``: each stage file contributes only the keys whose
    name contains the stage) and validates every tensor's shape against
    ``template`` ({"desc": tree, "pose": tree}: the flax trees of the target
    configuration's models, e.g. ``numpy_from_params`` of
    :func:`~bufferx_tpu_torch.pipeline.registration.init_params`). Returns
    the imported trees, {"desc": ..., "pose": ...}.
    """
    out = {}
    for stage, mapper in (
        ("Desc", desc_variables_from_reference),
        ("Pose", pose_variables_from_reference),
    ):
        pth = os.path.join(src_dir, stage, "best.pth")
        sd = load_state_dict(pth)
        sd = {k: v for k, v in sd.items() if stage in k}
        variables = mapper(sd)
        _check_tree(variables, template[stage.lower()])
        dst = os.path.join(out_dir, stage, "best.msgpack")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            f.write(msgpack_dumps(variables))
        out[stage.lower()] = variables
    return out
