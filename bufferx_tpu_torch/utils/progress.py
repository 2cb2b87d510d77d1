"""Progress display utilities (reference ``utils/progress_format.py``).

Per-dataset display-name normalization for the single-line eval progress UI
and a carriage-return progress writer with per-failure logging.
"""

from __future__ import annotations

import sys

__all__ = ["display_name", "ProgressLine"]

_DISPLAY = {
    "3DMatch": "3DMatch",
    "3DLoMatch": "3DLoMatch",
    "Scannetpp_iphone": "ScanNet++ (iPhone)",
    "Scannetpp_faro": "ScanNet++ (Faro)",
    "TIERS": "TIERS",
    "TIERS_hetero": "TIERS (hetero)",
    "KITTI": "KITTI",
    "WOD": "Waymo",
    "MIT": "Kimera-Multi",
    "KAIST": "HeLiPR-KAIST",
    "KAIST_hetero": "HeLiPR-KAIST (hetero)",
    "ETH": "ETH",
    "Oxford": "Newer College",
    "ModelNet40": "ModelNet40",
    "Synthetic": "Synthetic",
}


def display_name(dataset: str, src_sensor: str | None = None,
                 tgt_sensor: str | None = None) -> str:
    name = _DISPLAY.get(dataset, dataset)
    if src_sensor and tgt_sensor:
        return f"{name} {src_sensor}->{tgt_sensor}"
    return name


class ProgressLine:
    """Single-line ANSI progress with failure call-outs
    (reference ``test.py:194-249``)."""

    def __init__(self, dataset: str, total: int | None = None,
                 stream=sys.stderr):
        self.name = display_name(dataset)
        self.total = total
        self.stream = stream
        self.failures = 0

    def update(self, i: int, recall: float, rte: float, rre: float,
               success: bool, pair_id: str = ""):
        if not success:
            self.failures += 1
            self.stream.write(
                f"\n[fail] {self.name} {pair_id}: "
                f"rte {rte:.3f} rre {rre:.2f}\n"
            )
        total = f"/{self.total}" if self.total else ""
        self.stream.write(
            f"\r{self.name} [{i + 1}{total}] "
            f"recall {recall * 100:.1f}% fail {self.failures} "
            f"rte {rte:.3f} rre {rre:.2f}  "
        )
        self.stream.flush()

    def finish(self):
        self.stream.write("\n")
        self.stream.flush()
