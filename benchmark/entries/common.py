"""What the entries share: the record of a served pair, the random draws
made on the device from the seed, and the one read of a call's results."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.seeding import torch_seed

__all__ = ["Record", "make_draws", "read_results"]

RANK_RANGE = 1 << 30


@dataclasses.dataclass
class Record:
    """One pair served in the window, as it reached the host."""
    pair: int               # index in the pool
    call: int               # the entry call that served it
    batch: int              # batch within the call
    slot: int               # position within the batch
    pose: np.ndarray        # [4, 4] f32
    num_inliers: int
    num_mutual: int
    num_consensus: int
    scales_used: int
    valid: bool
    latency_s: float = float("nan")


def make_draws(env, tag: str, index: int, batch: int | None) -> tuple:
    """(strat_src, strat_tgt, ransac) of a pair (``batch`` None) or of a
    batch of ``batch`` pairs, drawn on the device from a generator seeded
    from (seed, tag, index): the strip offsets of the fused stratified query
    [num_fps, patch_sample] int32 in [0, max_points / patch_sample) for
    each cloud, then the RANSAC ranks [num_hypotheses, 3] int64 in
    [0, 2^30)."""
    s = env.statics
    lead = () if batch is None else (batch,)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(torch_seed(env.seed, tag, index))
    strips = s["max_points"] // s["patch_sample"]
    shape = lead + (s["num_fps"], s["patch_sample"])
    src = torch.randint(0, strips, shape, generator=gen, dtype=torch.int32,
                        device=env.device)
    tgt = torch.randint(0, strips, shape, generator=gen, dtype=torch.int32,
                        device=env.device)
    ranks = torch.randint(0, RANK_RANGE, lead + (s["num_hypotheses"], 3),
                          generator=gen, dtype=torch.int64,
                          device=env.device)
    return src, tgt, ranks


def read_results(results: list) -> list:
    """The poses and counts of a call's results in ONE copy to the host:
    [dict] of :class:`Record` fields."""
    n = len(results)
    poses = torch.stack([r.pose for r in results]).reshape(n, 16)
    counts = torch.stack([
        torch.stack([getattr(r, f) for r in results]).to(torch.float64)
        for f in ("num_inliers", "num_mutual", "num_consensus", "scales_used",
                  "valid")], dim=1)
    host = torch.cat([poses.to(torch.float64), counts], dim=1).cpu().numpy()
    return [dict(pose=h[:16].reshape(4, 4).astype(np.float32),
                 num_inliers=int(h[16]), num_mutual=int(h[17]),
                 num_consensus=int(h[18]), scales_used=int(h[19]),
                 valid=bool(h[20])) for h in host]
