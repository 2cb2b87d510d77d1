"""K4, the SPT cell query (``csrc/cell_query.cu``), "sampled" descriptor:
one launch a scale over the 2B * num_fps patches of S points. Reads a
point's xyz and mask (13 bytes) and the G cell centres, writes the first
``voxel_sample`` points of every cell, [K, G, ns, 3] f32. The operations
counted are the ring test of every point and ring (6 each)."""

from __future__ import annotations

from benchmark.roofline import PEAK_F32_PER_S

KERNEL = r"\bcell_query_kernel\b"


def launch(patches: int, points: int, cells: int, ring: int,
           nsample: int) -> tuple:
    return (patches * points * 13 + cells * 12
            + patches * cells * nsample * 3 * 4,
            6.0 * patches * points * (cells // ring), PEAK_F32_PER_S)


def launches(statics: dict, passes: list) -> list:
    if statics["desc_mode"] != "sampled":
        return []
    g = statics["rad_n"] * statics["ele_n"] * statics["azi_n"]
    return [launch(2 * b * statics["num_fps"], statics["patch_sample"], g,
                   statics["azi_n"], statics["voxel_sample"])
            for b, scales in passes for _s in scales]
