"""End-to-end registration throughput of the port on one card.

    python3 -m bufferx_tpu_torch.tools.bench

The sections of the JAX package's ``bench.py``, at its configuration
(``make_cfg("ModelNet40")`` with the ``hard_moments_r4ft2`` checkpoint's
``config.json``: 30208 points, 1500 keypoints, 3 scales, 8192 RANSAC
hypotheses), each with ``NUM_WARMUP`` pairs (or one batch) of warm-up and
``NUM_TIMED`` timed pairs:

1. full 3-scale single pairs (``register_pair``) on full-overlap pairs;
2. batched two-phase serving at B = 8 (``register_pairs_batched``, the
   shipped early-exit threshold) on the same pairs;
3. mixed-hardness batched serving at B = 8: ``hard_pair`` eval scenes with
   overlap U(0.3, 0.75), noise and density mismatch drawn per pair, where
   early exit really branches (the ``scales_used`` histogram, recall at
   RTE < 0.3 m);
4. host-dispatched early exit at B = 1 (``register_pair_early_exit``).

The random draws come from generators on the card (as the JAX bench's keys
live on its device): a CPU generator makes them on the host, ~12 M integers
a batch of 8, and the copy to the card waits for the queued work. Each
timed window is host wall time ending in ``torch.cuda.synchronize()``.
Wall time moves between runs with the host, so each section also gives the
card's own time: CUDA events around the window (the stream's timeline,
idle gaps included) and the summed kernel time of one more untimed unit (a
pair or a batch) under ``torch.profiler``, per pair. Prints the card's name
and power limit and logs to stderr; stdout is exactly one JSON line. Needs a
CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.data.hardsynth import hard_pair
from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu_torch.pipeline import registration as reg
from bufferx_tpu_torch.tools.weights import load_snapshot, load_snapshot_config

NUM_WARMUP = 2
NUM_TIMED = 32
BATCH = 8
SNAPSHOT = os.path.join(os.path.dirname(__file__), "..", "..", "snapshot",
                        "hard_moments_r4ft2")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def kernel_ms(fn) -> float:
    """Summed CUDA kernel time (ms) of one call of ``fn`` under the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def timed(fn, n_pairs: int, unit_fn, unit_pairs: int) -> dict:
    """Runs ``fn`` once as the timed window (host clock and CUDA events,
    ending in a synchronize), then ``unit_fn`` under the profiler; returns
    the section's numbers and ``fn``'s result."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    numbers = dict(pairs_per_s=n_pairs / wall,
                   wall_ms_per_pair=wall / n_pairs * 1e3,
                   event_ms_per_pair=start.elapsed_time(end) / n_pairs,
                   kernel_ms_per_pair=kernel_ms(unit_fn) / unit_pairs)
    return numbers, out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    cfg = make_cfg("ModelNet40").override(
        patch=dict(load_snapshot_config(SNAPSHOT), desc_mode="moments"))
    statics = reg.PipelineStatics.from_config(cfg)
    models = reg.build_models(statics, load_snapshot(SNAPSHOT), dev)
    log(f"statics: {statics}")
    cfg_ee = cfg.override(match=dict(enable_early_exit=True))

    pairs = []
    for i in range(NUM_WARMUP + NUM_TIMED):
        s, t, T = synthetic_pair_full_overlap(np.random.RandomState(i),
                                              num_points=24000)
        pairs.append((reg.prepare_cloud(s, cfg, seed=i, device=dev),
                      reg.prepare_cloud(t, cfg, seed=i, device=dev),
                      torch.from_numpy(T).to(dev)))
    timed_pairs = pairs[NUM_WARMUP:]
    out = {"metric": "scan_pairs_per_s_per_chip", "unit": "pairs/s",
           "device": torch.cuda.get_device_name(0), "smi": smi}

    def rtes(poses, gts):
        return se3.compute_rte(torch.stack(poses), torch.stack(gts)).tolist()

    # ---- 1. full 3-scale single pairs --------------------------------------
    gen = torch.Generator(dev).manual_seed(0)
    for src, tgt, _T in pairs[:NUM_WARMUP]:
        reg.register_pair(cfg, src, tgt, models, generator=gen, device=dev)

    def full():
        return [reg.register_pair(cfg, s, t, models, generator=gen,
                                  device=dev).pose for s, t, _ in timed_pairs]

    full_n, poses = timed(
        full, NUM_TIMED,
        lambda: reg.register_pair(cfg, *pairs[0][:2], models, generator=gen,
                                  device=dev), 1)
    full_n["rte_median"] = float(np.median(rtes(
        poses, [p[2] for p in timed_pairs])))
    log(f"full 3-scale: {full_n}")

    # ---- 2. batched two-phase, B = 8 ---------------------------------------
    srcs, tgts = [p[0] for p in pairs], [p[1] for p in pairs]
    gen_b = torch.Generator(dev).manual_seed(9)
    reg.register_pairs_batched(cfg_ee, srcs[:BATCH], tgts[:BATCH], models,
                               batch_size=BATCH, generator=gen_b, device=dev)
    b_n, res_b = timed(
        lambda: reg.register_pairs_batched(
            cfg_ee, srcs[NUM_WARMUP:], tgts[NUM_WARMUP:], models,
            batch_size=BATCH, generator=gen_b, device=dev),
        NUM_TIMED,
        lambda: reg.register_pairs_batched(
            cfg_ee, srcs[:BATCH], tgts[:BATCH], models, batch_size=BATCH,
            generator=gen_b, device=dev), BATCH)
    b_n["rte_median"] = float(np.median(rtes(
        [r.pose for r in res_b], [p[2] for p in timed_pairs])))
    log(f"batched (B={BATCH}): {b_n}")

    # ---- 3. mixed hardness, B = 8 ------------------------------------------
    mixed = []
    for i in range(NUM_TIMED):
        rs = np.random.RandomState(1000 + i)
        s, t, T = hard_pair(
            rs, family="eval", num_points=24000,
            overlap_ratio=float(rs.uniform(0.3, 0.75)),
            noise=float(rs.choice([0.0, 0.00625, 0.0125])),
            density_ratio=float(rs.choice([1.0, 1.0, 2.0, 4.0])),
        )
        mixed.append((reg.prepare_cloud(s, cfg, seed=i, device=dev),
                      reg.prepare_cloud(t, cfg, seed=i, device=dev),
                      torch.from_numpy(T).to(dev)))
    srcs_m, tgts_m = [p[0] for p in mixed], [p[1] for p in mixed]
    reg.register_pairs_batched(cfg_ee, srcs_m[:BATCH], tgts_m[:BATCH], models,
                               batch_size=BATCH,
                               generator=torch.Generator(dev).manual_seed(11),
                               device=dev)
    gen_m = torch.Generator(dev).manual_seed(12)
    m_n, res_m = timed(
        lambda: reg.register_pairs_batched(
            cfg_ee, srcs_m, tgts_m, models, batch_size=BATCH, generator=gen_m,
            device=dev),
        NUM_TIMED,
        lambda: reg.register_pairs_batched(
            cfg_ee, srcs_m[:BATCH], tgts_m[:BATCH], models,
            batch_size=BATCH, generator=torch.Generator(dev).manual_seed(13),
            device=dev), BATCH)
    scales = [int(r.scales_used) for r in res_m]
    m_n["scales_used"] = {k: scales.count(k) for k in sorted(set(scales))}
    m_rtes = rtes([r.pose for r in res_m], [p[2] for p in mixed])
    m_n["recall_rte0.3"] = float(np.mean([r < 0.3 for r in m_rtes]))
    log(f"mixed (B={BATCH}, overlap 0.3-0.75): {m_n}")

    # ---- 4. early exit, B = 1 ----------------------------------------------
    gen_e = torch.Generator(dev).manual_seed(21)
    for src, tgt, _T in pairs[:NUM_WARMUP]:
        reg.register_pair_early_exit(cfg_ee, src, tgt, models, generator=gen_e,
                                     device=dev)
    ee_n, res_e = timed(
        lambda: [reg.register_pair_early_exit(cfg_ee, s, t, models,
                                              generator=gen_e, device=dev)
                 for s, t, _ in timed_pairs],
        NUM_TIMED,
        lambda: reg.register_pair_early_exit(cfg_ee, *pairs[0][:2], models,
                                             generator=gen_e, device=dev), 1)
    ee_scales = [int(r.scales_used) for r in res_e]
    ee_n["scales_used"] = {k: ee_scales.count(k)
                           for k in sorted(set(ee_scales))}
    ee_n["rte_median"] = float(np.median(rtes(
        [r.pose for r in res_e], [p[2] for p in timed_pairs])))
    log(f"early exit (B=1): {ee_n}")

    out["value"] = max(full_n["pairs_per_s"], b_n["pairs_per_s"],
                       ee_n["pairs_per_s"])
    out["mixed_pairs_per_s"] = m_n["pairs_per_s"]
    out["mixed_scales_used"] = m_n["scales_used"]
    out["mixed_recall_rte0.3"] = m_n["recall_rte0.3"]
    out["full_3scale_pairs_per_s"] = full_n["pairs_per_s"]
    out["sections"] = {"full_3scale": full_n, "batched": b_n, "mixed": m_n,
                       "early_exit": ee_n}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
