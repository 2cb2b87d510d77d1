"""The share of the window's pairs registered within the traffic's success
thresholds (RTE below ``rte_m`` and RRE below ``rre_deg`` against the
ground truth); a pair without a valid result counts as a miss."""

import math

import numpy as np


def _rre_deg(est, gt):
    tr = float(np.sum(est[:3, :3].astype(np.float64) * gt[:3, :3]))
    c = min(max((tr - 1.0) / 2.0, -1.0), 1.0)
    return math.degrees(math.acos(c))


def read(run):
    if not run.records:
        return None
    ok = run.traffic["success"]
    hits = 0
    for r in run.records:
        gt = run.gt[r.pair]
        rte = float(np.linalg.norm(r.pose[:3, 3].astype(np.float64)
                                   - gt[:3, 3]))
        hits += bool(r.valid and rte < ok["rte_m"]
                     and _rre_deg(r.pose, gt) < ok["rre_deg"])
    return hits / len(run.records)
