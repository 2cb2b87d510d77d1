"""Snapshot weights: flax msgpack -> state dicts (frozen copy).

A copy of the port's checkpoint reader, so that the benchmark's reference
loads the snapshot files itself. A snapshot is ``<dir>/{Desc,Pose}/
best.msgpack``, written by ``flax.serialization.to_bytes``: standard msgpack
maps whose array leaves are msgpack ExtType code 1 carrying a packed
``(shape, dtype_name, bytes)``. Conv kernels are turned from flax's HWIO /
DHWIO layouts to PyTorch's OIHW / OIDHW.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

__all__ = ["load_snapshot"]


class _Reader:
    """Minimal msgpack decoder (the subset msgpack-python writes)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def read(self, raw: bool = False):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F, raw)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
            0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
            0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
            0xDC: ("H", "array"), 0xDD: ("I", "array"),
            0xDE: ("H", "map"), 0xDF: ("I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "ext":
                return self._ext(self.unpack("b"), n)
            if kind == "str":
                return self._str(n, raw)
            if kind == "array":
                return self._array(n, raw)
            return self._map(n, raw)
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:            # fixext 1, 2, 4, 8, 16
            code = self.unpack("b")
            return self._ext(code, 1 << (b - 0xD4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _str(self, n: int, raw: bool):
        s = self.take(n)
        return s if raw else s.decode("utf-8")

    def _array(self, n: int, raw: bool):
        return [self.read(raw) for _ in range(n)]

    def _map(self, n: int, raw: bool):
        out = {}
        for _ in range(n):
            k = self.read(raw)
            out[k] = self.read(raw)
        return out

    def _ext(self, code: int, n: int):
        payload = self.take(n)
        if code in (1, 3):               # ndarray, numpy scalar
            shape, dtype_name, buf = _Reader(payload).read(raw=True)
            if dtype_name == b"bfloat16":
                raise ValueError("bfloat16 checkpoint leaves are not supported")
            arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode()))
            arr = arr.reshape(shape)
            return arr[()] if code == 3 else arr
        if code == 2:                    # native complex
            re, im = _Reader(payload).read()
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext code {code}")


def _as_tuple(d):
    return tuple(d[str(i)] for i in range(len(d))) if isinstance(d, dict) else tuple(d)


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = _as_tuple(tree["shape"])
            return np.concatenate(_as_tuple(tree["chunks"])).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """Decode ``flax.serialization.to_bytes`` output into nested dicts of
    numpy arrays (the same tree ``flax.serialization.msgpack_restore``
    returns)."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


# flax module path -> port module path, per model
DESC_MODULES = {
    "ConvBNRelu_0": "stem",
    "CylindricalConvNet_0": "backbone",
    "ConvBNRelu_1": "att_hidden",
    "ConvBNRelu_2": "att_gate",
}
POSE_MODULES = {"ConvBNRelu_0": "stem",
                **{f"ConvBNRelu_{i}": f"layers.{i - 1}" for i in range(1, 10)}}
_LEAVES = {
    ("params", "Conv_0", "kernel"): "weight",
    ("params", "Conv_0", "bias"): "bias",
    ("params", "BatchNorm_0", "scale"): "bn_scale",
    ("params", "BatchNorm_0", "bias"): "bn_bias",
    ("batch_stats", "BatchNorm_0", "mean"): "bn_mean",
    ("batch_stats", "BatchNorm_0", "var"): "bn_var",
}


def _kernel_to_torch(w: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW, DHWIO -> OIDHW."""
    perm = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[w.ndim]
    return np.transpose(w, perm)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_numpy(tree: dict, modules: dict) -> dict:
    """Restored ``{params, batch_stats}`` tree -> state dict of the port's
    model, with ``modules`` mapping top-level flax names to port paths
    (:data:`DESC_MODULES`, :data:`POSE_MODULES` or :data:`UNET_MODULES`)."""
    sd = {}
    for path, leaf in _flatten(tree):
        collection, top, *mid, layer, name = path
        if top not in modules:
            raise KeyError(f"unmapped checkpoint module {'/'.join(path)}")
        port = modules[top]
        if mid:                            # e.g. CylindricalConvNet_0/ConvBNRelu_3
            (sub,) = mid
            port += "." + "layers." + sub.rsplit("_", 1)[1]
        leaf_name = _LEAVES[(collection, layer, name)]
        arr = np.asarray(leaf, dtype=np.float32)
        if leaf_name == "weight":
            arr = _kernel_to_torch(arr)
        sd[f"{port}.{leaf_name}"] = torch.from_numpy(np.array(arr, order="C"))
    return sd


def read_checkpoint(path: str, modules: dict) -> dict:
    """One stage's flax msgpack -> the port model's state dict."""
    with open(path, "rb") as f:
        return params_from_numpy(msgpack_restore(f.read()), modules)


def load_snapshot(snapshot_dir: str) -> dict:
    """``<dir>/{Desc,Pose}/best.msgpack`` -> {"desc": state_dict,
    "pose": state_dict} for :class:`MiniSpinNet` and :class:`CostVolume`."""
    return {stage.lower(): read_checkpoint(
                os.path.join(snapshot_dir, stage, "best.msgpack"), modules)
            for stage, modules in (("Desc", DESC_MODULES),
                                   ("Pose", POSE_MODULES))}
