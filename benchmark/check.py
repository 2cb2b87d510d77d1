"""Whether what the window served is correct: the plain reference
(``benchmark/reference/``) registers a sample of the window's pairs again
from the same raw clouds and draws, and each served pair is held against
it.

For a checked pair the gaps are the rotation angle between the served and
the reference pose (degrees), the distance between their translations (m)
and the relative gaps |served - reference| / max(reference, 1) of the
solver's inlier count and of the mutual-match count. The numbers
(:func:`numbers`) are the medians of these over the checked pairs, and
``far_share``: the share of the pairs the reference solved confidently
whose served pose lies farther from the reference's than the cell's
``far`` angle or distance, which sees a fault on a minority of pairs that
the medians pass. A cell's ``benchmark/checks/<workload>.json`` gives the
limit of each number it compares, the confidence threshold and the far
thresholds.

The reference runs in the configuration's precision (float32 with TF32
off, bf16 convolutions), or, as the control, with TF32 on.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from benchmark.reference import registration as ref
from benchmark.reference.weights import load_snapshot

__all__ = ["pair_gaps", "numbers", "judge", "reference_records"]


def rotation_gap_deg(a: np.ndarray, b: np.ndarray) -> float:
    """The angle between two rotations, from the Frobenius distance of
    their matrices (2 asin(|A - B|_F / sqrt 8)), exact near 0 where the
    trace's arccos is not."""
    d = np.linalg.norm(a[:3, :3].astype(np.float64)
                       - b[:3, :3].astype(np.float64))
    return math.degrees(2.0 * math.asin(min(d / math.sqrt(8.0), 1.0)))


def pair_gaps(served, reference) -> dict:
    """The gaps of one served pair (a Record) against the reference's
    (a dict of Record fields)."""
    return dict(
        rot_deg=rotation_gap_deg(served.pose, reference["pose"]),
        trans_m=float(np.linalg.norm(served.pose[:3, 3].astype(np.float64)
                                     - reference["pose"][:3, 3])),
        inlier_gap=abs(served.num_inliers - reference["num_inliers"])
        / max(reference["num_inliers"], 1),
        mutual_gap=abs(served.num_mutual - reference["num_mutual"])
        / max(reference["num_mutual"], 1),
        ref_inliers=reference["num_inliers"])


def numbers(gaps: list, rules: dict) -> dict:
    """The numbers over the checked pairs' gaps: the median of each gap,
    and ``far_share``, the share of the confident pairs (the reference
    solved them with at least ``rules["confident_inliers"]`` inliers) whose
    rotation gap exceeds ``rules["far"]["rot_deg"]`` or whose translation
    gap exceeds ``rules["far"]["trans_m"]`` (0 where no pair is
    confident)."""
    if not gaps:
        return {}

    def median(key):
        return float(np.median([g[key] for g in gaps]))

    far = rules["far"]
    sure = [g for g in gaps if g["ref_inliers"] >= rules["confident_inliers"]]
    off = [g for g in sure
           if g["rot_deg"] > far["rot_deg"] or g["trans_m"] > far["trans_m"]]
    return {"rot_gap_deg.median": median("rot_deg"),
            "trans_gap_m.median": median("trans_m"),
            "inlier_gap.median": median("inlier_gap"),
            "mutual_gap.median": median("mutual_gap"),
            "far_share": len(off) / len(sure) if sure else 0.0}


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number with a limit at
    or under it; a missing number is not correct."""
    out = {}
    ok = bool(limits)
    for name, limit in limits.items():
        v = values.get(name)
        out[name] = {"value": v, "limit": limit}
        ok = ok and v is not None and v <= limit
    return ok, out


def _host(res) -> dict:
    return dict(pose=res.pose.detach().cpu().numpy().astype(np.float32),
                num_inliers=int(res.num_inliers),
                num_mutual=int(res.num_mutual),
                num_consensus=int(res.num_consensus),
                scales_used=int(res.scales_used), valid=bool(res.valid))


def reference_records(root: str, config: dict, pool: list, groups: list,
                      device, tf32: bool = False) -> list:
    """The reference's result (a dict of Record fields) for every pair of
    ``groups`` [(kind, pair indices, (strat_src, strat_tgt, ransac) draws
    or a (phase-1, phase-2) pair of them, records)], in order. ``tf32``
    runs it with TF32 on (the control)."""
    s = ref.Statics.from_dict(config["statics"])
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        models = ref.build_models(
            s, load_snapshot(os.path.join(root, config["snapshot"])), device)
        out = []
        all_scales = tuple(range(s.num_scales))
        for kind, pairs, draws, _records in groups:
            srcs = [ref.prepare_cloud(pool[i][0], s.max_points, 2 * i, device)
                    for i in pairs]
            tgts = [ref.prepare_cloud(pool[i][1], s.max_points, 2 * i + 1,
                                      device) for i in pairs]
            if kind == "two_phase":
                d1, d2 = (ref.Draws(*d) for d in draws)
                res = ref.register_batches(models, s, srcs, tgts,
                                           [list(range(len(pairs)))],
                                           [(d1, d2)])
            else:
                (src,), (tgt,) = srcs, tgts
                batch = ref.register_batch(
                    models, s, ref.Cloud(src.xyz[None], src.mask[None]),
                    ref.Cloud(tgt.xyz[None], tgt.mask[None]),
                    ref.Draws(*(x[None] for x in draws)), all_scales)
                res = [ref.Result(*(x[0] for x in batch))]
            out += [_host(r) for r in res]
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]
