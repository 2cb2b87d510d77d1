"""Scaling benchmark: pair-sharded evaluation over ranks.

The port's counterpart of ``scripts/bench_scaling.py``. Measures scan-pairs/s
of :func:`~bufferx_tpu_torch.parallel.sharded.make_sharded_eval` at world
sizes 1, 2, 4, ... N and reports the scaling efficiency (throughput_N /
(N * throughput_1)). Each size starts its ranks anew with
:func:`~bufferx_tpu_torch.parallel.mesh.spawn`, as ``tools/dryrun.py``
does: one NCCL rank a card, N = ``torch.cuda.device_count()``; or, with
``--cpu-ranks N``, gloo ranks on the CPU (functional validation of the
sharded program: the ranks share one host, so the efficiency printed there
is no hardware measurement). Under ``torchrun`` it measures the one world
that ``torchrun`` started.

Every size registers ``--pairs-per-device`` pairs a rank; pair i is the same
synthetic full-overlap pair with the same draws (seeded by i) at every
size, so the poses do not depend on the world size. Prints one JSON line a
size and a summary line, with the JAX script's keys; logs go to stderr.

    python3 -m bufferx_tpu_torch.tools.bench_scaling
    python3 -m bufferx_tpu_torch.tools.bench_scaling --small --cpu-ranks 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from bufferx_tpu_torch import cuda_build
from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu_torch.parallel.mesh import make_mesh, spawn
from bufferx_tpu_torch.parallel.sharded import make_sharded_eval
from bufferx_tpu_torch.pipeline.registration import (
    PipelineStatics,
    init_params,
    make_draws,
    prepare_cloud,
)
from bufferx_tpu_torch.tools.weights import load_snapshot

__all__ = ["parse_args", "bench_config", "run", "main"]

REPS = 3     # timed runs a size, after one untimed run (the JAX script's)

def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pairs-per-device", type=int, default=4)
    p.add_argument("--points", type=int, default=24000)
    p.add_argument("--small", action="store_true",
                   help="small capacities (CPU validation)")
    p.add_argument("--cpu-ranks", type=int, default=0,
                   help="gloo ranks on the CPU instead of the cards: world "
                        "sizes 1, 2, 4, ... up to this")
    p.add_argument("--checkpoint-dir", default="snapshot/synthetic")
    return p.parse_args(argv)


def bench_config(small: bool):
    """ModelNet40 at full width, or the JAX script's ``--small``
    capacities."""
    cfg = make_cfg("ModelNet40")
    if small:
        cfg = cfg.override(
            capacity=dict(max_points=2048, num_ransac_hypotheses=512,
                          ransac_chunk=256, sphere_query_chunk=64),
            patch=dict(num_fps=256, num_points_radius_estimate=256,
                       num_points_per_patch=128, num_scales=1,
                       search_radius_thresholds=(5.0,)),
        )
    return cfg


def _bench_rank(mesh, args) -> dict:
    """One rank at one world size: registers world x pairs-per-device
    pairs, untimed once, then ``REPS`` timed runs. Returns the seconds
    a run, the poses and inlier counts, and the kernels' launches a run."""
    if mesh.device.type == "cpu":         # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // mesh.world_size))
    cfg = bench_config(args.small)
    points = min(args.points, 2048) if args.small else args.points
    if os.path.isdir(args.checkpoint_dir) and not args.small:
        params = load_snapshot(args.checkpoint_dir)
    else:
        params = init_params(cfg, torch.Generator().manual_seed(0))
    statics = PipelineStatics.from_config(cfg)
    dev = mesh.device
    eval_fn = make_sharded_eval(params, cfg, mesh)
    b = mesh.world_size * args.pairs_per_device
    srcs, tgts, draws = [], [], []
    for i in range(b):
        s, t, _ = synthetic_pair_full_overlap(np.random.RandomState(i),
                                              num_points=points)
        srcs.append(prepare_cloud(s, cfg, seed=i, device=dev))
        tgts.append(prepare_cloud(t, cfg, seed=i, device=dev))
        draws.append(make_draws(statics, torch.Generator().manual_seed(i),
                                dev, batch=1))
    draws = type(draws[0])(*(torch.cat(x) for x in zip(*draws)))

    def once():
        res = eval_fn(srcs, tgts, draws=draws, is_aligned=False)
        int(res.num_inliers.sum())          # waits for every rank's work
        return res

    once()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(REPS):
        res = once()
    dt = (time.perf_counter() - t0) / REPS
    launches = {n: k.launches // REPS
                for n, k in cuda_build.KERNELS.items()}
    return dict(pairs=b, seconds=dt, pose=res.pose.cpu(),
                num_inliers=res.num_inliers.cpu(), launches=launches)


def _line(n: int, out: dict, base: float) -> dict:
    pps = out["pairs"] / out["seconds"]
    return {"mesh": n, "pairs_per_s": round(pps, 3),
            "scaling_efficiency": round(pps / (base * n), 3)}


def run(argv=None) -> list:
    """Measure every world size, print the JSON lines, and return each
    size's rank-0 result (``pairs``, ``seconds``, ``pose``,
    ``num_inliers``, ``launches``) with its line under ``"line"``."""
    args = parse_args(argv)
    if "WORLD_SIZE" in os.environ:            # started by torchrun
        mesh = make_mesh(device="cpu" if args.cpu_ranks else "cuda")
        outs = [(mesh.world_size, _bench_rank(mesh, args))]
        if mesh.rank != 0:
            return [o for _, o in outs]
    else:
        device = "cpu" if args.cpu_ranks else "cuda"
        n_dev = args.cpu_ranks or torch.cuda.device_count()
        if n_dev < 1:
            raise RuntimeError("no card: pass --cpu-ranks N for gloo ranks "
                               "on the CPU")
        sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= n_dev]
        log(f"{n_dev} {'gloo ranks' if args.cpu_ranks else 'cards'}; world "
            f"sizes {sizes}")
        outs = [(n, spawn(_bench_rank, n, device, args=(args,))[0])
                for n in sizes]
    results = []
    base = outs[0][1]["pairs"] / outs[0][1]["seconds"]
    for n, out in outs:
        line = _line(n, out, base)
        out["line"] = line
        results.append(out)
        log(f"world size {n}: {out['pairs']} pairs in {out['seconds']:.3f} s "
            f"-> {line['pairs_per_s']:.2f} pairs/s, efficiency "
            f"{line['scaling_efficiency']:.2%}")
        print(json.dumps(line), flush=True)
    lines = [r["line"] for r in results]
    print(json.dumps({"metric": "scaling_efficiency",
                      "value": lines[-1]["scaling_efficiency"],
                      "unit": "ratio", "sizes": lines}), flush=True)
    return results


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
