"""Where one registration's, or one batch's, time goes on the card.

    python3 -m bufferx_tpu_torch.tools.trace_pair [--pairs 3] [--trace PATH]
        [--snapshot snapshot/hard --fused-conv] [--batch 8] [--dataset 3DMatch]

Runs the registration's stages at full width on seeded full-overlap pairs
after a warm-up: by default the main path (the shipped
``hard_moments_r4ft2`` weights, "moments" descriptor); ``--snapshot``
takes another checkpoint, whose ``config.json`` (if any) sets the
descriptor mode (``snapshot/hard`` has none: the reference "sampled"
descriptor), and ``--fused-conv`` runs the descriptor backbone as the
fused conv stack. It prints:

- per stage, the host wall time around the stage ending in a
  synchronize (precompute, each scale's candidates, consensus + solve);
- from ``torch.profiler`` over one ``register_pair``: the device time per
  kernel name (top 25), the summed device time, the wall time and the
  device's idle share (1 - device time / wall, one stream so kernels do
  not overlap);
- one JSON line with those numbers.

``--batch B`` takes batches of B pairs in the place of single pairs (the
stages of batched serving, ``--pairs`` batches after the warm-up), and
profiles two batch runs: scale 0 alone, which is phase 1 of
``register_pairs_batched``, and all scales, which is its phase 2 for a batch
whose pairs are all redone; device time, wall time and idle share of each,
also per pair, and the peak memory.

``--dataset`` takes another preset than ``ModelNet40``; with one that
turns the clutter prefilter on (``3DMatch``), the prefilter is also
profiled alone on the batch's 2B clouds: its device time and how far it
raises the allocated memory above what was allocated before it.

``--trace`` also writes the Chrome trace. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu_torch.kernels.density import density_inlier_mask
from bufferx_tpu_torch.pipeline import registration as reg
from bufferx_tpu_torch.tools.weights import load_snapshot, load_snapshot_config

SNAPSHOT = os.path.join(os.path.dirname(__file__), "..", "..", "snapshot",
                        "hard_moments_r4ft2")


def _staged(models, statics, src, tgt, draws) -> dict:
    """One batch (stacked clouds, batched draws; a single pair is the batch
    of one), stage by stage, with host wall times (ms)."""
    out = {}
    scales = tuple(range(statics.num_scales))
    t0 = time.perf_counter()
    pre = reg._precompute(statics, src, tgt, draws, scales)
    torch.cuda.synchronize()
    out["precompute"] = (time.perf_counter() - t0) * 1e3
    cands = []
    for s in scales:
        t0 = time.perf_counter()
        cands.append(reg._scale_candidates(models, statics, pre, draws, s, s,
                                           False))
        torch.cuda.synchronize()
        out[f"scale{s}"] = (time.perf_counter() - t0) * 1e3
    del pre
    t0 = time.perf_counter()
    reg._pool_and_solve(statics, reg._cat_candidates(cands), draws.ransac,
                        src, tgt, len(scales))
    torch.cuda.synchronize()
    out["solve"] = (time.perf_counter() - t0) * 1e3
    return out


def _profiled(fn, label: str, pairs: int) -> tuple:
    """``fn`` under the profiler: prints and returns (numbers, profile)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # kernel events only: operator events carry their kernels' time too
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    print(f"profiled {label}: wall {wall_ms:.2f} ms (under the profiler), "
          f"device {device_ms:.2f} ms, idle share "
          f"{1 - device_ms / wall_ms:.3f}, {sum(r[1] for r in rows)} "
          f"launches, peak memory {peak_gb:.2f} GB"
          + (f"; per pair: wall {wall_ms / pairs:.2f} ms, device "
             f"{device_ms / pairs:.2f} ms" if pairs > 1 else ""))
    for ms, count, key in rows[:25]:
        print(f"  {ms:9.3f} ms  {count:6d}x  {key[:90]}")
    numbers = {
        "profiled_wall_ms": wall_ms, "profiled_device_ms": device_ms,
        "idle_share": 1 - device_ms / wall_ms, "pairs": pairs,
        "launches": sum(r[1] for r in rows), "peak_memory_gb": peak_gb,
        "top_kernels_ms": {k[:90]: ms for ms, _c, k in rows[:25]},
    }
    return numbers, prof


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--trace", default="")
    ap.add_argument("--snapshot", default=SNAPSHOT,
                    help="checkpoint directory (Desc/, Pose/, config.json)")
    ap.add_argument("--fused-conv", action="store_true",
                    help="run the descriptor backbone as the fused stack")
    ap.add_argument("--batch", type=int, default=0,
                    help="pairs a batch (0: single pairs)")
    ap.add_argument("--dataset", default="ModelNet40",
                    help="configuration preset (make_cfg)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_pair needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)

    cfg = make_cfg(args.dataset).override(
        patch=dict(load_snapshot_config(args.snapshot),
                   fused_conv=args.fused_conv))
    statics = reg.PipelineStatics.from_config(cfg)
    print(f"{args.dataset}, snapshot {os.path.normpath(args.snapshot)}: "
          f"desc_mode {statics.desc_mode}, fused_conv {statics.fused_conv}, "
          f"clutter_filter {statics.clutter_filter}", flush=True)
    models = reg.build_models(statics, load_snapshot(args.snapshot), dev)
    size = max(args.batch, 1)
    batches = []
    for b in range(args.pairs + 1):
        srcs, tgts = [], []
        for i in range(b * size, (b + 1) * size):
            s, t, _T = synthetic_pair_full_overlap(np.random.RandomState(i),
                                                   24000)
            srcs.append(reg.prepare_cloud(s, cfg, seed=i, device=dev))
            tgts.append(reg.prepare_cloud(t, cfg, seed=i, device=dev))
        batches.append((reg.stack_clouds(srcs), reg.stack_clouds(tgts),
                        reg.make_draws(statics,
                                       torch.Generator().manual_seed(b), dev,
                                       batch=size)))

    _staged(models, statics, *batches[0])                      # warm-up
    stages = [_staged(models, statics, *batch) for batch in batches[1:]]
    med = {k: float(np.median([s[k] for s in stages])) for k in stages[0]}
    unit = f"batch of {size}" if args.batch else "pair"
    for k, v in med.items():
        print(f"stage {k}: {v:.2f} ms a {unit} (median of {len(stages)})")

    all_scales = tuple(range(statics.num_scales))
    src, tgt, draws = batches[1]
    result = {
        "device": torch.cuda.get_device_name(0), "smi": smi,
        "snapshot": os.path.normpath(args.snapshot), "dataset": args.dataset,
        "desc_mode": statics.desc_mode, "fused_conv": statics.fused_conv,
        "batch": args.batch, "stages_ms": med,
    }
    if statics.clutter_filter:
        xyz = torch.cat([src.xyz, tgt.xyz])
        mask = torch.cat([src.mask, tgt.mask])
        density_inlier_mask(xyz, mask)                          # warm-up
        torch.cuda.synchronize()
        before_gb = torch.cuda.memory_allocated() / 1e9
        numbers, _prof = _profiled(lambda: density_inlier_mask(xyz, mask),
                                   f"clutter filter, {2 * size} clouds", 1)
        numbers["memory_above_before_gb"] = (numbers["peak_memory_gb"]
                                             - before_gb)
        print(f"clutter filter: {numbers['memory_above_before_gb']:.2f} GB "
              "above the memory allocated before it", flush=True)
        result["clutter_filter"] = numbers
    if args.batch:
        reg._register_batch(models, statics, src, tgt, draws, (0,), False)
        for label, scales in (("scale 0", (0,)), ("all scales", all_scales)):
            numbers, prof = _profiled(
                lambda: reg._register_batch(models, statics, src, tgt, draws,
                                            scales, False),
                f"{unit}, {label}", size)
            result[label.replace(" ", "_")] = numbers
    else:
        # the entry point, its set-up and stacking included
        src1, tgt1 = (reg.Cloud(*(x[0] for x in c)) for c in (src, tgt))
        draws1 = type(draws)(*(x[0] for x in draws))
        numbers, prof = _profiled(
            lambda: reg.register_pair(cfg, src1, tgt1, models, draws=draws1,
                                      is_aligned=False, device=dev), unit, 1)
        result.update(numbers)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
