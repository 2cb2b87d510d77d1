"""Hard synthetic quality gate on the port (``scripts/exp_hard.py``'s cells).

    python3 -m bufferx_tpu_torch.tools.exp_hard \\
        --checkpoint-dir snapshot/hard_moments_r4ft2 --pairs-per-cell 200 \\
        [--set match.pose_estimator=gnc] [--cells 0,5,16] [--out FILE]
    python3 -m bufferx_tpu_torch.tools.exp_hard --cpu --quick \\
        --checkpoint-dir snapshot/hard_moments_r4ft2

Sweeps the 3DLoMatch-style operating axes on the held-out eval scene family
(:func:`bufferx_tpu_torch.data.hardsynth.hard_pair`): overlap {0.3, 0.5,
0.75} x noise {0, 0.5, 1.0} voxels; overlap x density mismatch {4:1, 10:1}
at 0.5-voxel noise; clutter {10%, 20%} at overlap 0.5 (17 cells; ``--quick``
keeps 7 at reduced capacities, a CPU smoke). The configuration is
``make_cfg("3DMatch")`` (clutter prefilter on) with the checkpoint's
``config.json``, the ``--set`` overrides and IRLS refinement. Every cell's
pairs go through :func:`register_batch` in batches of ``--batch`` with all
scales; the last batch of a cell is short when the batch does not divide
the pairs (nothing is padded). Success is RTE < 0.3 m and RRE < 15 degrees.

The pairs are those of ``scripts/exp_hard.py`` (pair seed ``seed * 1000 +
ci * 101 + i``, cloud seeds ``i`` and ``i + 1``). The random draws of cell
``ci`` come from a ``torch.Generator`` seeded ``seed + ci``, so a
``--cells`` subset scores the same draws as a full run. One JSON line a
cell (the JAX runner's keys, a 95% Wilson interval, plus the device, the
card's name and the cell's pairs per second of registration), then a
summary line. Runs on the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from bufferx_tpu_torch.config import Config, make_cfg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.data.hardsynth import hard_pair
from bufferx_tpu_torch.device import resolve_device
from bufferx_tpu_torch.pipeline import registration as reg
from bufferx_tpu_torch.tools.weights import load_snapshot, load_snapshot_config

Z95 = 1.959964
QUICK = dict(
    capacity=dict(max_points=4096, num_ransac_hypotheses=1024,
                  ransac_chunk=256, sphere_query_chunk=64),
    patch=dict(num_fps=384, num_points_radius_estimate=384,
               num_points_per_patch=256),
)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_cells(quick: bool) -> list:
    cells = []
    overlaps = (0.3, 0.5, 0.75)
    noises = (0.0, 0.5, 1.0)
    if quick:
        overlaps, noises = (0.3, 0.75), (0.0, 1.0)
    for ov in overlaps:
        for nz in noises:
            cells.append(dict(overlap=ov, noise_vox=nz, density=1.0,
                              clutter=0.0))
    for ov in overlaps:
        for dr in ((4.0,) if quick else (4.0, 10.0)):
            cells.append(dict(overlap=ov, noise_vox=0.5, density=dr,
                              clutter=0.0))
    for cl in ((0.2,) if quick else (0.1, 0.2)):
        cells.append(dict(overlap=0.5, noise_vox=0.5, density=1.0,
                          clutter=cl))
    return cells


def parse_set(overrides) -> list:
    """``section.key=value`` strings -> [(section, key, value)], the value
    an int, else a float, else true/false, else the string."""
    out = []
    for ov in overrides:
        path, _, raw = ov.partition("=")
        sec, _, k = path.partition(".")
        for cast in (int, float):
            try:
                val = cast(raw)
                break
            except ValueError:
                continue
        else:
            val = {"true": True, "false": False}.get(raw.lower(), raw)
        out.append((sec, k, val))
    return out


def gate_config(desc_mode="moments", checkpoint_dir="", overrides=(),
                exact_topk=False, no_block_ball_query=False, no_strat=False,
                no_clutter_filter=False, quick=False) -> Config:
    """The gate's configuration, built in ``scripts/exp_hard.py``'s order."""
    cfg = make_cfg("3DMatch").override(
        data=dict(root=""),
        patch=dict(
            desc_mode=desc_mode,
            exact_topk=exact_topk,
            block_ball_query=False if exact_topk else not no_block_ball_query,
            strat_ball_query=not no_strat,
        ),
        test=dict(pose_refine=True),
    )
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        snap = load_snapshot_config(checkpoint_dir)
        if snap:
            cfg = cfg.override(patch=snap)
    for sec, k, val in parse_set(overrides):
        cfg = cfg.override(**{sec: {k: val}})
    if no_clutter_filter:
        cfg = cfg.override(data=dict(clutter_filter=False))
    if quick:
        cfg = cfg.override(**QUICK)
    return cfg


def wilson(p: float, n: int) -> tuple:
    """95% Wilson score interval of a recall p from n pairs."""
    denom = 1.0 + Z95 * Z95 / n
    center = (p + Z95 * Z95 / (2 * n)) / denom
    half = Z95 * np.sqrt(p * (1 - p) / n + Z95 * Z95 / (4 * n * n)) / denom
    return max(center - half, 0.0), min(center + half, 1.0)


def cell_pairs(cell: dict, ci: int, pairs_per_cell: int, num_points: int,
               voxel: float, seed: int) -> list:
    """The cell's pairs: [(src, tgt, T_gt)], numpy."""
    out = []
    for i in range(pairs_per_cell):
        rs = np.random.RandomState(seed * 1000 + ci * 101 + i)
        out.append(hard_pair(
            rs, family="eval", num_points=num_points,
            overlap_ratio=cell["overlap"], noise=cell["noise_vox"] * voxel,
            density_ratio=cell["density"], outlier_frac=cell["clutter"]))
    return out


def run_cell(cfg: Config, models, cell: dict, ci: int, *, pairs_per_cell: int,
             num_points: int, batch: int, voxel: float, seed: int, device,
             draws=None) -> dict:
    """One cell: its pairs through :func:`register_batch` in batches.

    ``draws``: one :class:`Draws` a batch (a test feeds the JAX package's);
    otherwise from a generator seeded ``seed + ci``. Returns the JSON row,
    with the per-pair successes under ``"successes"`` (not printed)."""
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(seed + ci)
    statics = reg.PipelineStatics.from_config(cfg)
    rtes, rres, seconds = [], [], 0.0
    pairs = cell_pairs(cell, ci, pairs_per_cell, num_points, voxel, seed)
    for bi, start in enumerate(range(0, pairs_per_cell, batch)):
        idx = range(start, min(start + batch, pairs_per_cell))
        srcs = [reg.prepare_cloud(pairs[i][0], cfg, seed=i, device=dev)
                for i in idx]
        tgts = [reg.prepare_cloud(pairs[i][1], cfg, seed=i + 1, device=dev)
                for i in idx]
        gts = torch.from_numpy(np.stack([pairs[i][2] for i in idx])).to(dev)
        bd = (draws[bi] if draws is not None
              else reg.make_draws(statics, gen, dev, batch=len(idx)))
        t0 = time.perf_counter()
        res = reg.register_batch(cfg, srcs, tgts, models, draws=bd,
                                 is_aligned=False, device=dev)
        rtes += se3.compute_rte(res.pose, gts).tolist()   # the fence
        rres += se3.compute_rre(res.pose, gts).tolist()
        seconds += time.perf_counter() - t0
    rtes, rres = np.asarray(rtes), np.asarray(rres)
    succ = (rtes < cfg.test.rte_thresh) & (rres < cfg.test.rre_thresh)
    n = len(rtes)
    p = float(succ.mean())
    lo, hi = wilson(p, n)
    return dict(
        cell, mode=cfg.patch.desc_mode, exact_topk=cfg.patch.exact_topk,
        n=n, recall=round(p, 4),
        wilson_lo=round(lo, 4), wilson_hi=round(hi, 4),
        rte_med=round(float(np.median(rtes)), 4),
        rre_med=round(float(np.median(rres)), 3),
        rte_med_succ=(round(float(np.median(rtes[succ])), 4)
                      if succ.any() else None),
        device=dev.type, device_name=device_name(dev),
        pairs_per_s=n / seconds,
        successes=succ.tolist(),
    )


def device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--desc-mode", choices=["sampled", "moments"],
                    default="moments")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--pairs-per-cell", type=int, default=50)
    ap.add_argument("--num-points", type=int, default=24000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--voxel", type=float, default=0.025,
                    help="noise unit (meters); the sweep is in voxels")
    ap.add_argument("--exact-topk", action="store_true",
                    help="exact top-k sampling (the port's queries are "
                         "exact already); turns the block query off")
    ap.add_argument("--no-block-ball-query", action="store_true",
                    help="flat ball query instead of the two-level blocks "
                         "(no effect while the stratified query runs)")
    ap.add_argument("--no-strat", action="store_true",
                    help="force the flat/block ball query instead of the "
                         "fused stratified one")
    ap.add_argument("--no-clutter-filter", action="store_true",
                    help="disable the density clutter prefilter")
    ap.add_argument("--quick", action="store_true",
                    help="reduced grid + capacities (CPU smoke)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=20240)
    ap.add_argument("--out", default="",
                    help="append JSON lines here as well as stdout")
    ap.add_argument("--cells", default="",
                    help="comma-separated cell indices (build_cells order)")
    ap.add_argument("--set", action="append", default=[],
                    help="config override section.key=value, repeatable")
    args = ap.parse_args(argv)

    cfg = gate_config(args.desc_mode, args.checkpoint_dir, args.set,
                      args.exact_topk, args.no_block_ball_query,
                      args.no_strat, args.no_clutter_filter, args.quick)
    if args.quick:
        args.num_points = min(args.num_points, 4096)
        args.pairs_per_cell = min(args.pairs_per_cell, args.batch)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    statics = reg.PipelineStatics.from_config(cfg)
    reg._check_ported(statics)
    if not (args.checkpoint_dir and os.path.isdir(args.checkpoint_dir)):
        raise SystemExit("--checkpoint-dir: a snapshot directory is needed "
                         "(the port has no initializer for untrained "
                         "weights)")
    models = reg.build_models(statics, load_snapshot(args.checkpoint_dir),
                              dev)
    log(f"checkpoint {args.checkpoint_dir}; statics {statics}")
    cells = list(enumerate(build_cells(args.quick)))
    if args.cells:
        want = {int(c) for c in args.cells.split(",")}
        cells = [(i, c) for i, c in cells if i in want]
    log(f"device {device_name(dev)} mode={args.desc_mode} "
        f"cells={len(cells)} pairs/cell={args.pairs_per_cell} thresholds "
        f"RTE<{cfg.test.rte_thresh} RRE<{cfg.test.rre_thresh}")

    out_f = open(args.out, "a") if args.out else None
    try:
        rows = []
        t_start = time.perf_counter()
        for run_i, (ci, cell) in enumerate(cells):
            row = run_cell(cfg, models, cell, ci,
                           pairs_per_cell=args.pairs_per_cell,
                           num_points=args.num_points, batch=args.batch,
                           voxel=args.voxel, seed=args.seed, device=dev)
            row.pop("successes")
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if out_f:
                out_f.write(line + "\n")
                out_f.flush()
            log(f"[{run_i + 1}/{len(cells)} cell {ci}] ov={cell['overlap']} "
                f"nz={cell['noise_vox']} dr={cell['density']} "
                f"cl={cell['clutter']}: recall {row['recall']:.2f} "
                f"rte_med {row['rte_med'] * 1000:.0f}mm rre "
                f"{row['rre_med']:.2f}, {row['pairs_per_s']:.2f} pairs/s")
        summary = dict(metric="hard_synth_mean_recall", mode=args.desc_mode,
                       exact_topk=args.exact_topk,
                       value=round(float(np.mean([r["recall"]
                                                  for r in rows])), 4),
                       elapsed_s=round(time.perf_counter() - t_start, 1),
                       device=dev.type, device_name=device_name(dev))
        print(json.dumps(summary), flush=True)
        if out_f:
            out_f.write(json.dumps(summary) + "\n")
    finally:
        if out_f:
            out_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
