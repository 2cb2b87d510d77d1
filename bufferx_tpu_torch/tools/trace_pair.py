"""Where one registration's time goes on the card.

    python3 -m bufferx_tpu_torch.tools.trace_pair [--pairs 3] [--trace PATH]
        [--snapshot snapshot/hard --fused-conv]

Runs ``register_pair``'s stages at full width on seeded full-overlap pairs
after a warm-up: by default the main path (the shipped
``hard_moments_r4ft2`` weights, "moments" descriptor); ``--snapshot``
takes another checkpoint, whose ``config.json`` (if any) sets the
descriptor mode (``snapshot/hard`` has none: the reference "sampled"
descriptor), and ``--fused-conv`` runs the descriptor backbone as the
fused conv stack. It prints:

- per stage, the host wall time around the stage ending in a
  synchronize (precompute, each scale's candidates, consensus + solve);
- from ``torch.profiler`` over one pair: the device time per kernel name
  (top 25), the summed device time, the wall time and the device's idle
  share (1 - device time / wall, one stream so kernels do not overlap);
- one JSON line with those numbers.

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
from bufferx_tpu_torch.pipeline import registration as reg
from bufferx_tpu_torch.tools.weights import load_snapshot, load_snapshot_config

SNAPSHOT = os.path.join(os.path.dirname(__file__), "..", "..", "snapshot",
                        "hard_moments_r4ft2")


def _staged(models, statics, src, tgt, draws) -> dict:
    """One registration, stage by stage, with host wall times (ms)."""
    out = {}
    t0 = time.perf_counter()
    pre = reg._precompute(statics, src, tgt, draws)
    torch.cuda.synchronize()
    out["precompute"] = (time.perf_counter() - t0) * 1e3
    cands = []
    for s in range(statics.num_scales):
        t0 = time.perf_counter()
        cands.append(reg._scale_candidates(models, statics, pre, s, False))
        torch.cuda.synchronize()
        out[f"scale{s}"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cand = reg._Candidates(*(torch.cat(xs) for xs in zip(*cands)))
    reg._pool_and_solve(statics, cand, draws.ransac, src, tgt,
                        statics.num_scales)
    torch.cuda.synchronize()
    out["solve"] = (time.perf_counter() - t0) * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--trace", default="")
    ap.add_argument("--snapshot", default=SNAPSHOT,
                    help="checkpoint directory (Desc/, Pose/, config.json)")
    ap.add_argument("--fused-conv", action="store_true",
                    help="run the descriptor backbone as the fused stack")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_pair needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)

    cfg = make_cfg("ModelNet40").override(
        patch=dict(load_snapshot_config(args.snapshot),
                   fused_conv=args.fused_conv))
    statics = reg.PipelineStatics.from_config(cfg)
    print(f"snapshot {os.path.normpath(args.snapshot)}: desc_mode "
          f"{statics.desc_mode}, fused_conv {statics.fused_conv}", flush=True)
    models = reg.build_models(statics, load_snapshot(args.snapshot), dev)
    pairs = []
    for i in range(args.pairs + 1):
        s, t, _T = synthetic_pair_full_overlap(np.random.RandomState(i), 24000)
        pairs.append((reg.prepare_cloud(s, cfg, seed=i, device=dev),
                      reg.prepare_cloud(t, cfg, seed=i, device=dev)))
    draws = [reg.make_draws(statics, torch.Generator().manual_seed(i), dev)
             for i in range(len(pairs))]

    _staged(models, statics, *pairs[0], draws[0])              # warm-up
    stages = [_staged(models, statics, *pairs[i], draws[i])
              for i in range(1, len(pairs))]
    med = {k: float(np.median([s[k] for s in stages])) for k in stages[0]}
    for k, v in med.items():
        print(f"stage {k}: {v:.2f} ms (median of {len(stages)})")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        reg.register_pair(cfg, *pairs[1], models, draws=draws[1], device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel events only: operator events carry their kernels' time too
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    print(f"profiled pair: wall {wall_ms:.2f} ms (under the profiler), "
          f"device {device_ms:.2f} ms, idle share "
          f"{1 - device_ms / wall_ms:.3f}")
    for ms, count, key in rows[:25]:
        print(f"  {ms:9.3f} ms  {count:6d}x  {key[:90]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "smi": smi,
        "snapshot": os.path.normpath(args.snapshot),
        "desc_mode": statics.desc_mode, "fused_conv": statics.fused_conv,
        "stages_ms": med, "profiled_wall_ms": wall_ms,
        "profiled_device_ms": device_ms,
        "idle_share": 1 - device_ms / wall_ms,
        "top_kernels_ms": {k[:90]: ms for ms, _c, k in rows[:25]},
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
