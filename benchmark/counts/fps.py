"""K1, farthest point sampling (``csrc/fps.cu``): one launch a pass over
the pass's 2B clouds, ``num_probe`` rounds. Reads xyz (12 bytes) and the
mask (1 byte) a point, writes an int32 index a round and cloud; a round is
9 operations a point (difference, square, sum, running minimum)."""

from __future__ import annotations

from benchmark.roofline import PEAK_F32_PER_S

KERNEL = r"\bfps_kernel\b"


def launch(clouds: int, points: int, rounds: int) -> tuple:
    return (clouds * points * 13 + clouds * rounds * 4,
            9.0 * clouds * rounds * points, PEAK_F32_PER_S)


def launches(statics: dict, passes: list) -> list:
    return [launch(2 * b, statics["max_points"], statics["num_probe"])
            for b, _scales in passes]
