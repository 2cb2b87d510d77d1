"""Where a training step's time goes on the card.

    python3 -m bufferx_tpu_torch.tools.trace_train
        [--snapshot snapshot/hard_moments_r4ft2] [--steps 20] [--trace PATH]

At ``tools/train_synthetic.py``'s configuration (4096-point clouds, 256
correspondences, 256-point patches, float32), from the given snapshot (its
``config.json`` sets the descriptor), on a pool of 4 ``hard_training_stream``
batches: per stage (Desc, then Pose with the Desc net frozen), after 3
warm-up steps,

- ms a step by CUDA events over ``--steps`` steps, and the peak memory;
- from ``torch.profiler`` over 5 steps: device time and wall time a step,
  the device's idle share (1 - device time / wall; one stream), kernel
  launches a step, and the device time by kernel name (top 25);
- one JSON line with those numbers.

``--trace`` also writes the Chrome trace of the Pose stage's profiled steps
(``PATH``) and of the Desc stage's (``PATH`` with ``desc`` before the
suffix). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from bufferx_tpu_torch.data.hardsynth import hard_training_stream
from bufferx_tpu_torch.data.training import pool_batch, stack_batches
from bufferx_tpu_torch.tools.trace_pair import SNAPSHOT, _profiled
from bufferx_tpu_torch.tools.train_synthetic import training_config
from bufferx_tpu_torch.tools.weights import load_snapshot, load_snapshot_config
from bufferx_tpu_torch.train.forward import TrainStatics, make_train_draws
from bufferx_tpu_torch.train.trainer import (
    make_optimizer,
    make_train_step,
    train_models,
)

POOL = 4
WARMUP = 3
PROFILED = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snapshot", default=SNAPSHOT)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_train needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    knobs = load_snapshot_config(args.snapshot)
    cfg = training_config(knobs.get("desc_mode", "sampled"),
                          knobs.get("desc_pool", "gated"),
                          knobs.get("desc_width", 1.0))
    statics = TrainStatics.from_config(cfg)
    pool = stack_batches(list(hard_training_stream(
        cfg, POOL, seed=7, num_points=4000, host_arrays=True)), dev)
    desc, pose = train_models(cfg, load_snapshot(args.snapshot), dev)
    gen = torch.Generator(dev).manual_seed(1)
    result = {"device": torch.cuda.get_device_name(0), "smi": smi,
              "snapshot": os.path.normpath(args.snapshot),
              "desc_mode": statics.desc_mode, "desc_pool": cfg.patch.desc_pool,
              "desc_width": cfg.patch.desc_width}
    for stage, model, frozen in (("Desc", desc, None), ("Pose", pose, desc)):
        opt = make_optimizer(cfg, stage, 100)
        step_fn = make_train_step(cfg, stage, opt)
        state = [opt.init(dict(model.named_parameters()))]
        count = [0]

        def steps(n):
            for _ in range(n):
                batch = pool_batch(pool, count[0] % POOL)
                draws = make_train_draws(statics, cfg.capacity.max_points,
                                         gen, dev)
                extra = () if frozen is None else (frozen,)
                state[0], _m = step_fn(model, state[0], *extra, batch, draws)
                count[0] += 1

        steps(WARMUP)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        steps(args.steps)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / args.steps
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"{stage}: {ms:.3f} ms a step over {args.steps} steps (CUDA "
              f"events), peak memory {peak:.3f} GB", flush=True)
        numbers, prof = _profiled(lambda: steps(PROFILED),
                                  f"{stage}, {PROFILED} steps", PROFILED)
        per_step = {k: numbers[k] / PROFILED for k in
                    ("profiled_wall_ms", "profiled_device_ms", "launches")}
        result[stage] = dict(ms_per_step=ms, peak_memory_gb=peak,
                             steps=args.steps, per_step=per_step,
                             idle_share=numbers["idle_share"],
                             top_kernels_ms=numbers["top_kernels_ms"])
        if args.trace:
            root, ext = os.path.splitext(args.trace)
            path = args.trace if stage == "Pose" else f"{root}.desc{ext}"
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            prof.export_chrome_trace(path)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
