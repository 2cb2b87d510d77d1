"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded through ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes). Libraries land in ``bufferx_tpu_torch/_build/``
(git-ignored) under a name that hashes the source and the flags, so an edited
source never reuses a stale build. Nothing is compiled at import: a kernel is
built the first time it is launched, or all at once, in parallel, by
:func:`build_all`.

Every C entry point takes its pointers, sizes and the CUDA stream, launches
on that stream, allocates nothing and returns ``cudaGetLastError()``;
:meth:`CudaKernel.launch` raises when that is not 0 and otherwise adds one to
the kernel's launch count. That count sees the launches the host makes
through the wrapper, and not those a replayed CUDA graph makes:
:func:`count_launches` counts the kernels of a device trace by each
kernel's device functions, whichever launched them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

import torch

__all__ = ["CudaKernel", "KERNELS", "build_all", "count_launches",
           "reset_launch_counts"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and /usr/local/cuda/bin)")


class CudaKernel:
    """One CUDA source, its C entry point and its launch count.

    ``replaces`` names the Pallas kernel (file:line) it stands in for, or is
    None for a kernel that stands in for none;
    ``argtypes`` are the entry's ctypes argument types before the stream.
    ``functions``: the ``__global__`` functions of which the entry launches
    one a call (``<name>_kernel`` unless given).
    ``launches`` counts successful launches by :meth:`launch`, and nothing
    else: reset it with :func:`reset_launch_counts`.
    """

    def __init__(self, name: str, source: str, replaces: str | None,
                 entry: str, argtypes: list, functions: tuple = ()):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.entry = entry
        self.argtypes = argtypes
        self.functions = functions or (f"{name}_kernel",)
        # a device function's name as a trace gives it, demangled: the
        # function's, after a namespace or a space, before its template or
        # parameter list
        self.symbol = re.compile(
            r"(?<![\w])(?:%s)(?=[<(])" % "|".join(self.functions))
        self.launches = 0
        self.ptxas_log = ""
        self._lib = None

    @property
    def source_path(self) -> str:
        return os.path.join(_CSRC, self.source)

    def lib_path(self) -> str:
        h = hashlib.sha256()
        headers = sorted(n for n in os.listdir(_CSRC) if n.endswith(".cuh"))
        for part in (self.source, *headers):
            with open(os.path.join(_CSRC, part), "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(_BUILD, f"{self.name}-{h.hexdigest()[:16]}.so")

    def _start_build(self):
        """Start ``nvcc`` for this source; None if the library exists."""
        out = self.lib_path()
        if os.path.exists(out):
            return None
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", _CSRC, "-o", tmp, self.source_path]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        return proc, tmp, out

    def _finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, out = started
        log, _ = proc.communicate()
        self.ptxas_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{log}")
        os.replace(tmp, out)

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self._finish_build(self._start_build())
            lib = ctypes.CDLL(self.lib_path())
            fn = getattr(lib, self.entry)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.bx_strerror.argtypes = [ctypes.c_int]
            lib.bx_strerror.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, *args) -> None:
        """Call the C entry with ``args`` + the current stream; raise on a
        CUDA error, else count the launch."""
        lib = self.lib()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, self.entry)(*args, ctypes.c_void_p(stream))
        if err != 0:
            msg = lib.bx_strerror(err).decode()
            raise RuntimeError(
                f"{self.name}: {self.entry} failed: CUDA error {err} ({msg})")
        self.launches += 1


KERNELS: dict = {}


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.name] = kernel
    return kernel


def build_all() -> float:
    """Compile every registered kernel that is not built yet, one ``nvcc``
    per source, all started together. Returns the wall seconds taken."""
    # importing the kernel modules registers their kernels
    from bufferx_tpu_torch.geometry import spt_pallas  # noqa: F401
    from bufferx_tpu_torch.kernels import (  # noqa: F401
        conv_epilogue,
        conv_pallas,
        fps,
        hyp_score,
        strat_pallas,
    )

    t0 = time.perf_counter()
    kernels = list(KERNELS.values())
    started = [k._start_build() for k in kernels]
    for k, s in zip(kernels, started):
        k._finish_build(s)
    for k in kernels:
        k.lib()
    return time.perf_counter() - t0


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def count_launches(kernel_names) -> dict:
    """{kernel: launches} of every registered kernel among the device
    kernels named ``kernel_names`` (a trace's kernel events, demangled)."""
    counts = dict.fromkeys(KERNELS, 0)
    for name in kernel_names:
        for k in KERNELS.values():
            if k.symbol.search(name):
                counts[k.name] += 1
                break
    return counts


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    """The kernels take contiguous CUDA tensors of one dtype each."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
