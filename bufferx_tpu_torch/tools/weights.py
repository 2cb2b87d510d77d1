"""Checkpoints: flax msgpack <-> PyTorch state dicts, no flax needed.

The JAX package saves ``{params, batch_stats}`` trees with
``flax.serialization.to_bytes``: standard msgpack maps whose array leaves
are msgpack ExtType code 1 carrying a packed ``(shape, dtype_name, bytes)``
triple (code 3 is a numpy scalar in the same encoding; arrays too large for
one ext are split into ``{"__msgpack_chunked_array__", "chunks", "shape"}``
maps). :func:`msgpack_restore` reads that with the standard library and
numpy only, because the card's machine has neither ``msgpack`` nor ``flax``.

:func:`params_from_numpy` maps a restored tree onto the port's modules
(the inverse of ``bufferx_tpu/tools/torch_import.py``): conv kernels
HWIO/DHWIO -> OIHW/OIDHW, BatchNorm ``scale``/``bias`` -> ``bn_scale``/
``bn_bias``, running ``mean``/``var`` -> ``bn_mean``/``bn_var``.

The other way, :func:`numpy_from_params` turns a port state dict back into
the flax tree and :func:`msgpack_dumps` writes a tree in the bytes
``flax.serialization.to_bytes`` gives for it (keys in insertion order),
arrays split into chunks above ``MAX_CHUNK_SIZE`` bytes as
flax splits them. :func:`save_snapshot` writes a snapshot both packages'
loaders read: ``<dir>/{Desc,Pose}/best.msgpack`` and ``config.json``.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

__all__ = [
    "MAX_CHUNK_SIZE",
    "msgpack_restore",
    "msgpack_dumps",
    "params_from_numpy",
    "numpy_from_params",
    "save_snapshot",
    "save_snapshot_config",
    "load_snapshot",
    "load_snapshot_config",
    "read_checkpoint",
    "write_checkpoint",
    "DESC_MODULES",
    "POSE_MODULES",
    "UNET_MODULES",
]


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


MAX_CHUNK_SIZE = 2 ** 30      # bytes; flax.serialization's constant


def _pack_len(out: bytearray, n: int, small: int, small_max: int,
              codes: tuple) -> None:
    """A msgpack length header: ``small | n`` for n < small_max, else one of
    ``codes`` (8-, 16-, 32-bit lengths; None where the format has none)."""
    if small is not None and n < small_max:
        out.append(small | n)
        return
    for code, fmt, top in zip(codes, ("B", "H", "I"), (0xFF, 0xFFFF,
                                                       0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack object too large: {n}")


def _pack_int(out: bytearray, v: int) -> None:
    """msgpack-python's choice of integer format."""
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")) if v > 0 \
        else ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q"))
    for code, fmt in forms:
        try:
            packed = struct.pack(">" + fmt, v)
        except struct.error:
            continue
        out.append(code)
        out += packed
        return
    raise ValueError(f"integer out of msgpack's range: {v}")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """``msgpack.packb((shape, dtype name, C-order bytes))``, the payload of
    flax's array ext type."""
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _chunked(arr: np.ndarray):
    """flax's ``_chunk``: an array above MAX_CHUNK_SIZE bytes as a map of
    flat chunks."""
    step = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + step] for i in range(0, flat.size, step)]
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(out: bytearray, v, top: bool = False) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, np.ndarray):
        if top and v.size * v.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(out, _chunked(v))
        else:
            _pack_ext(out, 1, _ndarray_payload(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, 3, _ndarray_payload(np.asarray(v)))
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(v, (bytes, bytearray)):
        _pack_len(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, list):
        _pack_len(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x, top=True)
    else:
        raise TypeError(f"cannot serialize {type(v).__name__}")


def msgpack_dumps(tree) -> bytes:
    """A tree of dicts (str keys) with numpy arrays, numpy scalars, Python
    numbers, strings, booleans and None as leaves, in the bytes
    ``flax.serialization.to_bytes`` writes for it: arrays as ext
    type 1, numpy scalars as ext type 3, arrays above ``MAX_CHUNK_SIZE``
    bytes chunked."""
    out = bytearray()
    _pack(out, tree, top=True)
    return bytes(out)


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
# a CylindricalUNet's own tree: its nine layers in call order
UNET_MODULES = {f"ConvBNRelu_{i}": name for i, name in enumerate(
    ("stem", "enc1", "enc2", "enc3", "bott", "dec3", "dec2", "dec1", "final"))}
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


def numpy_from_params(state_dict: dict, modules: dict) -> dict:
    """Port state dict -> ``{"params": ..., "batch_stats": ...}`` numpy tree
    of the JAX model (the inverse of :func:`params_from_numpy`): conv
    kernels OIHW/OIDHW -> HWIO/DHWIO, float32 leaves, keys sorted as a JAX
    pytree orders them."""
    leaves = {v: k for k, v in _LEAVES.items()}
    by_len = sorted(modules.items(), key=lambda kv: -len(kv[1]))
    tree: dict = {}
    for key, t in state_dict.items():
        for top, port in by_len:
            if key.startswith(port + "."):
                rest = key[len(port) + 1:].split(".")
                break
        else:
            raise KeyError(f"unmapped state-dict entry {key}")
        mid = ()
        if len(rest) == 3 and rest[0] == "layers":   # backbone layer i
            mid = (f"ConvBNRelu_{rest[1]}",)
        elif len(rest) != 1:
            raise KeyError(f"unmapped state-dict entry {key}")
        collection, layer, name = leaves[rest[-1]]
        arr = t.detach().to("cpu", torch.float32).numpy()
        if rest[-1] == "weight":
            perm = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[arr.ndim]
            arr = np.ascontiguousarray(np.transpose(arr, np.argsort(perm)))
        node = tree.setdefault(collection, {}).setdefault(top, {})
        for part in mid + (layer,):
            node = node.setdefault(part, {})
        node[name] = arr
    return _sorted(tree)


def _sorted(tree):
    """Keys in sorted order at every level, the order of a JAX pytree (and
    so of the checkpoints the JAX package writes)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def load_snapshot_config(snapshot_dir: str) -> dict:
    """Architecture overrides recorded with a snapshot ({} when none)."""
    path = os.path.join(snapshot_dir, "config.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        got = json.load(f)
    return {k: got[k] for k in ("desc_mode", "desc_pool", "desc_width")
            if k in got}


def read_checkpoint(path: str, modules: dict) -> dict:
    """One stage's flax msgpack -> the port model's state dict."""
    with open(path, "rb") as f:
        return params_from_numpy(msgpack_restore(f.read()), modules)


def write_checkpoint(path: str, state_dict: dict, modules: dict) -> str:
    """One stage's state dict -> a flax msgpack at ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = msgpack_dumps(numpy_from_params(state_dict, modules))
    with open(path, "wb") as f:
        f.write(data)
    return path


def load_snapshot(snapshot_dir: str) -> dict:
    """``<dir>/{Desc,Pose}/best.msgpack`` -> {"desc": state_dict,
    "pose": state_dict} for :class:`MiniSpinNet` and :class:`CostVolume`."""
    return {stage.lower(): read_checkpoint(
                os.path.join(snapshot_dir, stage, "best.msgpack"), modules)
            for stage, modules in (("Desc", DESC_MODULES),
                                   ("Pose", POSE_MODULES))}


def save_snapshot_config(snapshot_dir: str, cfg) -> str:
    """Record the architecture knobs of ``cfg`` (a Config) that a checkpoint
    was trained with, as ``<dir>/config.json``: they change the parameter
    tree, and serving reads them (:func:`load_snapshot_config`)."""
    os.makedirs(snapshot_dir, exist_ok=True)
    path = os.path.join(snapshot_dir, "config.json")
    with open(path, "w") as f:
        json.dump({k: getattr(cfg.patch, k)
                   for k in ("desc_mode", "desc_pool", "desc_width")}, f)
    return path


def save_snapshot(snapshot_dir: str, state_dicts: dict, cfg) -> str:
    """Write {"desc": state_dict, "pose": state_dict} as
    ``<dir>/{Desc,Pose}/best.msgpack`` and ``cfg``'s architecture knobs as
    ``<dir>/config.json``; returns ``snapshot_dir``."""
    for stage, modules in (("Desc", DESC_MODULES), ("Pose", POSE_MODULES)):
        write_checkpoint(os.path.join(snapshot_dir, stage, "best.msgpack"),
                         state_dicts[stage.lower()], modules)
    save_snapshot_config(snapshot_dir, cfg)
    return snapshot_dir
