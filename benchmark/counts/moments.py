"""K3, SPT moment pooling (``csrc/moments.cu``), "moments" descriptor: one
launch a scale over the 2B * num_fps patches of S points. Reads a point's
xyz and mask (13 bytes) and the G cell centres, writes [K, 10, G] f32. The
operations counted are the ring test of every point and ring (6 each); the
exact tests and the sums depend on the data and are not counted."""

from __future__ import annotations

from benchmark.roofline import PEAK_F32_PER_S

KERNEL = r"\bmoments_kernel\b"


def launch(patches: int, points: int, cells: int, ring: int) -> tuple:
    return (patches * points * 13 + cells * 12 + patches * 10 * cells * 4,
            6.0 * patches * points * (cells // ring), PEAK_F32_PER_S)


def launches(statics: dict, passes: list) -> list:
    if statics["desc_mode"] != "moments":
        return []
    g = statics["rad_n"] * statics["ele_n"] * statics["azi_n"]
    p = statics["patch_sample"] // statics["spt_pool_subsample"]
    return [launch(2 * b * statics["num_fps"], p, g, statics["azi_n"])
            for b, scales in passes for _s in scales]
