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

- the program's own spans (``bufferx_tpu_torch.utils.timers``): the
  ``--pairs`` pairs through ``register_pair``, each ending in one
  synchronize, under ``tracing()``; then, from ``spans()``, the first
  call's tree (each span under its parent, with its pairs, stream ms and
  host ms) and the spans by name: how many, and their stream ms (the
  stages': the stream's time between CUDA events at the span's ends, no
  fence in between) and host ms, a pair (the pairs of the calls' roots);
- from ``torch.profiler`` over one ``register_pair``: the device time per
  kernel name (top 25), the device time of every kernel, copy and fill,
  the wall time, and the device's idle share: 1 - the union of the device
  operations' intervals over the profiled window;
- the serving epilogue's launches a pair (``KERNELS["conv_epilogue"]``)
  and the conv layers' eval-mode forwards on the card that took the eager
  chain a pair (``conv_epilogue.eager_serving_forwards``, 0 on the main
  path), over the traced pairs; the hypothesis scoring's launches
  (``KERNELS["hyp_score"]``: the consensus and RANSAC, one each a solve) a
  pair and a traced call (a pair, or a batch with ``--batch``);
- the RANSAC hypotheses scored a pair (the host counter
  ``solver.ransac.HYPOTHESES``, read with the spans), over the traced
  pairs;
- one JSON line with those numbers.

``--batch B`` serves ``--pairs`` batches of B pairs after the warm-up
through ``register_pairs_batched`` at batch size B (two-phase serving:
its tree holds ``bufferx.phase1``, ``bufferx.phase2`` and a
``bufferx.fetch`` a batch), and profiles two batch runs: scale 0 alone,
which is phase 1 of ``register_pairs_batched``, and all scales, which is
its phase 2 for a batch whose pairs are all redone; device time, wall time
and idle share of each, also per pair, and the peak memory.

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
import tempfile
import time

import numpy as np
import torch

from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.cuda_build import KERNELS, reset_launch_counts
from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu_torch.kernels import conv_epilogue
from bufferx_tpu_torch.kernels.density import density_inlier_mask
from bufferx_tpu_torch.pipeline import registration as reg
from bufferx_tpu_torch.solver.ransac import HYPOTHESES
from bufferx_tpu_torch.tools.weights import load_snapshot, load_snapshot_config
from bufferx_tpu_torch.utils.timers import counters, spans, tracing

SNAPSHOT = os.path.join(os.path.dirname(__file__), "..", "..", "snapshot",
                        "hard_moments_r4ft2")
# the Chrome trace's categories of device operations, and the span that
# bounds the profiled window
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "trace_pair.window"


def _device_ops(prof) -> tuple:
    """(window (start, end), [(name, start, duration, category)] of the
    device operations) in us, from the profile's Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    window, ops = None, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if ev.get("cat") in DEVICE_CATEGORIES:
            ops.append((ev.get("name", "?"), start, dur, ev["cat"]))
        elif ev.get("name") == WINDOW and ev.get("cat") == "user_annotation":
            window = (start, start + dur)
    return window, ops


def _busy_us(ops: list, window: tuple) -> float:
    """Length of the union of the operations' intervals inside ``window``."""
    busy, end = 0.0, window[0]
    for _n, s, d, _c in sorted(ops, key=lambda op: op[1]):
        s, e = max(s, end), min(s + d, window[1])
        if e > s:
            busy += e - s
            end = e
    return busy


def _profiled(fn, label: str, pairs: int) -> tuple:
    """``fn`` under the profiler: prints and returns (numbers, profile)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans()                       # the program's spans of the profiled run
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    window, ops = _device_ops(prof)
    by_name: dict = {}
    for name, _s, d, cat in ops:
        if cat == "kernel":
            ms, count = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + d / 1e3, count + 1)
    rows = sorted(((ms, count, key) for key, (ms, count) in by_name.items()),
                  reverse=True)
    launches = sum(r[1] for r in rows)
    device_ms = sum(op[2] for op in ops) / 1e3
    window_ms = (window[1] - window[0]) / 1e3
    idle = 1 - _busy_us(ops, window) / 1e3 / window_ms
    print(f"profiled {label}: wall {wall_ms:.2f} ms (under the profiler), "
          f"device {device_ms:.2f} ms, idle share {idle:.3f} of the "
          f"{window_ms:.2f} ms window, {launches} launches, peak memory "
          f"{peak_gb:.2f} GB"
          + (f"; per pair: wall {wall_ms / pairs:.2f} ms, device "
             f"{device_ms / pairs:.2f} ms" if pairs > 1 else ""))
    for ms, count, key in rows[:25]:
        print(f"  {ms:9.3f} ms  {count:6d}x  {key[:90]}")
    numbers = {
        "profiled_wall_ms": wall_ms, "profiled_device_ms": device_ms,
        "window_ms": window_ms, "idle_share": idle, "pairs": pairs,
        "launches": launches, "peak_memory_gb": peak_gb,
        "top_kernels_ms": {k[:90]: ms for ms, _c, k in rows[:25]},
    }
    return numbers, prof


def _span_tree(records: list) -> list:
    """[(depth, record)] of the first call's spans (those under the root
    that opened first), in the order they opened, each under its parent."""
    if not records:
        return []
    first = min(records, key=lambda r: r.id).root
    depth: dict = {}
    out = []
    for r in sorted((r for r in records if r.root == first),
                    key=lambda r: r.id):
        depth[r.id] = depth[r.parent] + 1 if r.parent is not None else 0
        out.append((depth[r.id], r))
    return out


def _span_table(records: list) -> dict:
    """{span name: {"count", "stream_ms", "host_ms"}}, the times a pair
    (over the pairs of the calls' roots; stream ms None for the spans that
    do not time the stream), names in the order they first opened."""
    pairs = sum(r.pairs or 0 for r in records if r.parent is None) or 1
    table: dict = {}
    for r in sorted(records, key=lambda r: r.id):
        row = table.setdefault(r.name, {"count": 0, "stream_ms": None,
                                        "host_ms": 0.0})
        row["count"] += 1
        if r.stream_ms is not None:
            row["stream_ms"] = (row["stream_ms"] or 0.0) + r.stream_ms / pairs
        row["host_ms"] += r.host_ms / pairs
    return table


def _reset_counts() -> int:
    """Zero the kernels' launch counts; the eager-served count as it is."""
    reset_launch_counts()
    return conv_epilogue.eager_serving_forwards


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
        batches.append((srcs, tgts,
                        reg.make_draws(statics,
                                       torch.Generator().manual_seed(b), dev,
                                       batch=size)))

    def register(srcs, tgts, draws):
        if args.batch:
            return reg.register_batch(cfg, srcs, tgts, models, draws=draws,
                                      is_aligned=False, device=dev)
        return reg.register_pair(cfg, srcs[0], tgts[0], models,
                                 draws=type(draws)(*(x[0] for x in draws)),
                                 is_aligned=False, device=dev)

    def serve(batches):
        return reg.register_pairs_batched(
            cfg, [s for b in batches for s in b[0]],
            [t for b in batches for t in b[1]], models, batch_size=size,
            draws=[(b[2], b[2]) for b in batches], is_aligned=False,
            device=dev)

    if args.batch:
        serve(batches[:1])                                     # warm-up
        counts = _reset_counts()
        with tracing():
            serve(batches[1:])
            torch.cuda.synchronize()
    else:
        register(*batches[0])                                  # warm-up
        counts = _reset_counts()
        with tracing():
            for batch in batches[1:]:
                register(*batch)
                torch.cuda.synchronize()
    traced_pairs = args.pairs * size
    unit = f"batch of {size}" if args.batch else "pair"
    epilogue = {"conv_epilogue_launches_per_pair":
                KERNELS["conv_epilogue"].launches / traced_pairs,
                "eager_served_per_pair":
                (conv_epilogue.eager_serving_forwards - counts) / traced_pairs,
                "hyp_score_launches_per_pair":
                KERNELS["hyp_score"].launches / traced_pairs,
                "hyp_score_launches_per_call":
                KERNELS["hyp_score"].launches / args.pairs}
    print(f"conv epilogue: {epilogue['conv_epilogue_launches_per_pair']:g} "
          f"launches a pair, {epilogue['eager_served_per_pair']:g} conv "
          "forwards a pair served by the eager chain", flush=True)
    print(f"hypothesis scoring: "
          f"{epilogue['hyp_score_launches_per_pair']:g} launches a pair, "
          f"{epilogue['hyp_score_launches_per_call']:g} a {unit}",
          flush=True)
    records = spans()
    epilogue["ransac_hypotheses_per_pair"] = (
        counters().get(HYPOTHESES, 0) / traced_pairs)
    print(f"ransac: {epilogue['ransac_hypotheses_per_pair']:g} hypotheses "
          "scored a pair", flush=True)
    tree = _span_tree(records)
    def ms(x):
        return "-" if x is None else f"{x:.2f} ms"

    for depth, r in tree:
        print(f"{'  ' * depth}{r.name} ({r.pairs or '-'} pairs): stream "
              f"{ms(r.stream_ms)}, host {ms(r.host_ms)}")
    table = _span_table(records)
    for name, row in table.items():
        print(f"span {name}: {row['count']}x, stream {ms(row['stream_ms'])},"
              f" host {ms(row['host_ms'])} a pair")

    all_scales = tuple(range(statics.num_scales))
    srcs, tgts, draws = batches[1]
    src, tgt = reg.stack_clouds(srcs), reg.stack_clouds(tgts)
    result = {
        "device": torch.cuda.get_device_name(0), "smi": smi,
        "snapshot": os.path.normpath(args.snapshot), "dataset": args.dataset,
        "desc_mode": statics.desc_mode, "fused_conv": statics.fused_conv,
        "batch": args.batch, "spans": table, **epilogue,
        "span_tree": [[depth, r.name, r.pairs, r.stream_ms, r.host_ms]
                      for depth, r in tree],
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
        numbers, prof = _profiled(lambda: register(srcs, tgts, draws), unit,
                                  1)
        result.update(numbers)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
