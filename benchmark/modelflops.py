"""The model arithmetic of a pipeline pass, counted from shapes.

The descriptor net over one patch and the cost-volume head over one
correspondence are counted once, by PyTorch's FLOP counter over the
benchmark's reference copies of the two nets on the ``meta`` device (shapes
only, nothing is computed); their convolutions and products run in bf16 on
the tensor cores. Mutual matching is one f32 product of the two clouds'
descriptors a pair and scale, ``2 * num_fps^2 * 32`` operations. A pass of
B pairs through R scales describes 2B * num_fps patches and runs the head
over B * num_fps correspondences, once a scale.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.models.heads import CostVolume
from benchmark.reference.models.spinnet import MiniSpinNet
from benchmark.roofline import PEAK_BF16_PER_S, PEAK_F32_PER_S

__all__ = ["unit_flops", "least_seconds"]

DESC_DIM = 32


def unit_flops(statics: dict) -> dict:
    """{"patch": the descriptor net's operations a patch, "correspondence":
    the head's a correspondence}."""
    dt = torch.bfloat16 if statics["use_bf16"] else torch.float32
    r, e, a = statics["rad_n"], statics["ele_n"], statics["azi_n"]
    g = r * e * a
    with torch.device("meta"):
        desc = MiniSpinNet(r, e, a, mode=statics["desc_mode"],
                           pool=statics["desc_pool"],
                           width=statics["desc_width"],
                           compute_dtype=dt).eval()
        head = CostVolume(a, compute_dtype=dt).eval()
        x = (torch.empty(1, 10, g) if statics["desc_mode"] == "moments"
             else torch.empty(1, g, statics["voxel_sample"], 3))
        with FlopCounterMode(display=False) as per_patch:
            desc(x)
        maps = torch.empty(1, DESC_DIM, e - 2, a)
        with FlopCounterMode(display=False) as per_corr:
            head(maps, maps)
    return {"patch": per_patch.get_total_flops(),
            "correspondence": per_corr.get_total_flops()}


def least_seconds(statics: dict, units: dict, passes: list) -> float:
    """The least time the chip needs for the model arithmetic of
    ``passes`` [(pairs, scales)]: the nets at the bf16 peak (the f32 peak
    when the configuration runs them in f32), matching at the f32 peak."""
    nf = statics["num_fps"]
    peak = PEAK_BF16_PER_S if statics["use_bf16"] else PEAK_F32_PER_S
    total = 0.0
    for b, scales in passes:
        r = len(scales)
        nets = r * (2 * b * nf * units["patch"]
                    + b * nf * units["correspondence"])
        match = r * b * 2.0 * nf * nf * DESC_DIM
        total += nets / peak + match / PEAK_F32_PER_S
    return total
