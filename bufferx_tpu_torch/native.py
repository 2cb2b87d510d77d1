"""ctypes bindings for the port's native host library.

The port's counterpart of :mod:`bufferx_tpu.native`, with the same entry
points and signatures: voxel downsampling, radius neighbours, kNN and FPS
on the host, over numpy arrays. The port keeps its own copy of the C++
source (``csrc/host/bufferx_native.cpp``) and builds it with the host C++
compiler (``$CXX``, else ``c++``) at first use into ``_build/`` (git-ignored),
under a name that hashes the source and the flags. It never builds in, or
writes to, the JAX package's ``native/`` directory.

No fallback: an entry point whose library cannot be built raises, with the
compiler's output. :func:`available` reports whether the library builds
and loads, and :func:`build` whether it built, as in the JAX API.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

__all__ = [
    "available",
    "build",
    "voxel_downsample",
    "radius_neighbors",
    "knn",
    "fps",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "host", "bufferx_native.cpp")
_BUILD = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")
_lib = None


def _cxx() -> str:
    return os.environ.get("CXX", "c++")


def lib_path() -> str:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join((_cxx(),) + CXX_FLAGS).encode())
    return os.path.join(_BUILD, f"libbufferx_native-{h.hexdigest()[:16]}.so")


def _compile(quiet: bool = True) -> str:
    """Build the library unless it exists; returns its path, raises
    ``RuntimeError`` with the compiler's output on failure."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"host library: no C++ compiler ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(f"host library: {' '.join(cmd)} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    if not quiet:
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_compile())
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.bx_voxel_downsample.restype = ctypes.c_int64
    lib.bx_voxel_downsample.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_float, f32p, ctypes.c_int64,
    ]
    lib.bx_radius_neighbors.restype = ctypes.c_int32
    lib.bx_radius_neighbors.argtypes = [
        f32p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_float,
        ctypes.c_int32, i32p,
    ]
    lib.bx_knn.restype = ctypes.c_int32
    lib.bx_knn.argtypes = [
        f32p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_float, i32p, f32p,
    ]
    lib.bx_fps.restype = ctypes.c_int32
    lib.bx_fps.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32, i32p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds (if it is not built yet) and loads."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def build(quiet: bool = True) -> bool:
    """Compile the library into ``_build/`` (if it is not built yet).
    Returns success."""
    global _lib
    try:
        _compile(quiet)
    except RuntimeError:
        return False
    _lib = None
    return available()


def _c3(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)[:, :3])


def voxel_downsample(pts, voxel: float, capacity: int | None = None):
    """Barycenter voxel downsample -> [M, 3] float32."""
    lib = _load()
    pts = _c3(pts)
    cap = capacity or len(pts)
    out = np.empty((cap, 3), np.float32)
    m = lib.bx_voxel_downsample(pts, len(pts), float(voxel), out, cap)
    return out[:m].copy()


def radius_neighbors(queries, pts, radius: float, max_count: int):
    """[Nq, max_count] int32 neighbor indices, -1 padded."""
    lib = _load()
    queries = _c3(queries)
    pts = _c3(pts)
    out = np.empty((len(queries), max_count), np.int32)
    lib.bx_radius_neighbors(
        queries, len(queries), pts, len(pts), float(radius),
        int(max_count), out,
    )
    return out


def knn(queries, pts, k: int, cell_size: float | None = None):
    """k nearest neighbors -> (idx [Nq, k] int32, d2 [Nq, k] f32)."""
    lib = _load()
    queries = _c3(queries)
    pts = _c3(pts)
    if cell_size is None:
        span = pts.max(0) - pts.min(0)
        cell_size = float(max(span.max(), 1e-3)) / max(
            (len(pts) ** (1.0 / 3.0)), 1.0
        )
    idx = np.empty((len(queries), k), np.int32)
    d2 = np.empty((len(queries), k), np.float32)
    lib.bx_knn(queries, len(queries), pts, len(pts), int(k),
               float(cell_size), idx, d2)
    return idx, d2


def fps(pts, k: int) -> np.ndarray:
    """Host farthest point sampling -> [k] int32 indices."""
    lib = _load()
    pts = _c3(pts)
    out = np.empty(k, np.int32)
    lib.bx_fps(pts, len(pts), int(k), out)
    return out
