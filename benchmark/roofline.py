"""Published peaks of one NVIDIA H100 SXM (dense, 700 W) and the least time
a piece of work needs on it: the larger of its bytes over the memory's
rate and its operations over the peak of the precision it runs in."""

from __future__ import annotations

__all__ = ["PEAK_BYTES_PER_S", "PEAK_F32_PER_S", "PEAK_BF16_PER_S",
           "bound_s"]

PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_F32_PER_S = 67e12          # float32 outside the tensor cores
PEAK_BF16_PER_S = 989e12        # bf16 on the tensor cores


def bound_s(nbytes: float, ops: float, peak_ops: float) -> float:
    """Seconds: max(bytes / HBM rate, ops / ``peak_ops``)."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / peak_ops)


def kernel_share(run, kernels=None):
    """Percent: the least time of the traced passes' launches of
    ``kernels`` (names of ``counts/`` modules; all of them when None) over
    the device time the trace gives kernels of those names, so that a
    metric of one kernel is ``kernel_share(run, [name])``. Kernels with no
    launch counted or none traced are left out; None when none is left."""
    import re

    from benchmark.harness import count_modules

    if run.trace is None:
        return None
    mods = count_modules(run.bench)
    names = sorted(mods) if kernels is None else kernels
    traced = run.trace.kernels()
    least = measured = 0.0
    for name in names:
        mod = mods[name]
        work = mod.launches(run.statics, run.traced_passes)
        pattern = re.compile(mod.KERNEL)
        took = sum(d for n, _s, d in traced if pattern.search(n)) * 1e-6
        if work and took > 0:
            least += sum(bound_s(*w) for w in work)
            measured += took
    return least / measured * 100.0 if measured > 0 else None
