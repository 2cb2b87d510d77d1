"""K2, the fused stratified ball query (``csrc/strat.cu``): one launch a
pass for the 2B clouds and the pass's R radii. Reads the f32 distances
[C, K, N], the quantized points [C, 3, N], the offsets [C, K, S] and the
radii [C, R]; writes the packed words [C, R, 3, K, S] (4 bytes each). A
distance costs a compare and a select, and three packed minima a radius."""

from __future__ import annotations

from benchmark.roofline import PEAK_F32_PER_S

KERNEL = r"\bstrat_kernel\b"


def launch(clouds: int, centres: int, points: int, nsample: int,
           radii: int) -> tuple:
    words = (clouds * centres * points + clouds * 3 * points
             + clouds * centres * nsample + clouds * radii
             + clouds * radii * 3 * centres * nsample)
    return (4 * words, clouds * centres * points * (2.0 + 3.0 * radii),
            PEAK_F32_PER_S)


def applies(statics: dict) -> bool:
    n, s = statics["max_points"], statics["patch_sample"]
    return statics["strat_ball_query"] and n % s == 0 and n // s < 128


def launches(statics: dict, passes: list) -> list:
    if not applies(statics):
        return []
    return [launch(2 * b, statics["num_fps"], statics["max_points"],
                   statics["patch_sample"], len(scales))
            for b, scales in passes]
