"""Train the Desc and then the Pose stage on procedural synthetic pairs.

The port's counterpart of ``scripts/train_synthetic.py``:

    python3 -m bufferx_tpu_torch.tools.train_synthetic --hard \\
        --desc-mode moments --init-from snapshot/hard_moments_r4ft2 \\
        --steps N --pose-steps M --out DIR

The configuration is ``make_cfg("ModelNet40")`` with 4096-point clouds,
256-point patches, 128-patch sphere chunks and 256 correspondences a step
(the one every shipped checkpoint was trained with). Batches are built on
the host into a pool of ``--pool`` batches, copied to the card once, and
the steps cycle through it. ``--hard`` draws pairs from
``hard_training_stream`` (randomized overlap, noise, density mismatch and
clutter); ``--curriculum`` runs the Desc stage through phases of harder
pairs, ``--phases`` through the phases given as JSON. Every 50 steps the
metrics are read (the only host reads of a step loop), appended to
``DIR/scalars.jsonl`` and shown to the Desc stage's collapse guard, which
restores the last healthy state and ends the stage on a collapse. The
result is a snapshot both packages load: ``DIR/{Desc,Pose}/best.msgpack``
and ``DIR/config.json``. ``--cpu`` runs on the CPU (the kernels' plain
versions), for small checks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.data.hardsynth import hard_training_stream
from bufferx_tpu_torch.data.training import (
    pool_batch,
    stack_batches,
    synthetic_training_stream,
)
from bufferx_tpu_torch.device import resolve_device
from bufferx_tpu_torch.pipeline.registration import init_params
from bufferx_tpu_torch.tools.weights import load_snapshot, save_snapshot_config
from bufferx_tpu_torch.train.forward import TrainStatics, make_train_draws
from bufferx_tpu_torch.train.guard import CollapseGuard
from bufferx_tpu_torch.train.trainer import (
    make_optimizer,
    make_train_step,
    save_params,
    train_models,
)

__all__ = ["CURRICULUM", "training_config", "main"]

LOG_EVERY = 50

# Desc-stage curriculum phases (fractions of --steps; the knobs are
# hard_training_stream's arguments), the JAX script's schedule: the last
# phases sit at the hard gate's operating point (overlap 0.1-0.6, density
# mismatch up to 10:1, clutter up to 20%)
CURRICULUM = [
    dict(frac=0.12, overlap_range=(0.5, 0.9), noise_range=(0.0, 0.5),
         density_choices=(1.0, 1.0, 2.0), clutter_choices=(0.0, 0.0)),
    dict(frac=0.18, overlap_range=(0.35, 0.8), noise_range=(0.0, 0.8),
         density_choices=(1.0, 1.0, 2.0, 4.0),
         clutter_choices=(0.0, 0.0, 0.05)),
    dict(frac=0.25, overlap_range=(0.2, 0.7), noise_range=(0.0, 1.0),
         density_choices=(1.0, 1.0, 2.0, 4.0, 8.0),
         clutter_choices=(0.0, 0.0, 0.05, 0.1)),
    dict(frac=0.25, overlap_range=(0.1, 0.6), noise_range=(0.0, 1.2),
         density_choices=(1.0, 2.0, 4.0, 8.0, 10.0),
         clutter_choices=(0.0, 0.05, 0.1, 0.2)),
    dict(frac=0.2, overlap_range=(0.1, 0.4), noise_range=(0.0, 1.0),
         density_choices=(1.0, 2.0, 4.0, 8.0, 10.0),
         clutter_choices=(0.0, 0.05, 0.1, 0.2)),
]


def training_config(desc_mode: str = "sampled", desc_pool: str = "gated",
                    desc_width: float = 1.0, lr_scale: float = 1.0):
    """The training configuration of ``scripts/train_synthetic.py``."""
    cfg = make_cfg("ModelNet40").override(
        capacity=dict(max_points=4096, sphere_query_chunk=128),
        patch=dict(num_points_per_patch=256, desc_mode=desc_mode,
                   desc_pool=desc_pool, desc_width=desc_width),
        train=dict(pos_num=256),
    )
    if lr_scale != 1.0:
        cfg = cfg.override(optim=dict(lr_desc=cfg.optim.lr_desc * lr_scale,
                                      lr_pose=cfg.optim.lr_pose * lr_scale))
    return cfg


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--pose-steps", type=int, default=600)
    ap.add_argument("--pool", type=int, default=96, help="resident batches")
    ap.add_argument("--out", default="snapshot/synthetic")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--num-points", type=int, default=4000)
    ap.add_argument("--desc-mode", default="sampled",
                    choices=["sampled", "moments"])
    ap.add_argument("--desc-pool", default="gated",
                    choices=["gated", "softmax"])
    ap.add_argument("--desc-width", type=float, default=1.0)
    ap.add_argument("--hard", action="store_true",
                    help="pairs from hard_training_stream")
    ap.add_argument("--curriculum", action="store_true",
                    help="the Desc stage through CURRICULUM (implies --hard)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--init-from", default="",
                    help="snapshot dir to start both stages from")
    ap.add_argument("--lr-scale", type=float, default=1.0)
    ap.add_argument("--phases", default="",
                    help='JSON list of Desc phases [{"steps": N, ...knobs}] '
                         "(implies --hard; the Pose stage keeps the "
                         "mid-hard distribution)")
    args = ap.parse_args(argv)
    if args.curriculum or args.phases:
        args.hard = True
    return args


def _stage_phases(args):
    """(Desc phases, Pose phases) as lists of (steps, knobs or None)."""
    pose_knobs = {k: v for k, v in CURRICULUM[2].items() if k != "frac"}
    if args.phases:
        desc = []
        for p in json.loads(args.phases):
            knobs = {k: (tuple(v) if isinstance(v, list) else v)
                     for k, v in p.items() if k != "steps"}
            desc.append((int(p["steps"]), knobs))
        args.steps = sum(n for n, _ in desc)
        return desc, [(args.pose_steps, pose_knobs)]
    if args.curriculum:
        desc = [(max(int(args.steps * p["frac"]), 1),
                 {k: v for k, v in p.items() if k != "frac"})
                for p in CURRICULUM]
        return desc, [(args.pose_steps, pose_knobs)]
    return [(args.steps, None)], [(args.pose_steps, None)]


def main(argv=None) -> int:
    args = _parse(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = training_config(args.desc_mode, args.desc_pool, args.desc_width,
                          args.lr_scale)
    statics = TrainStatics.from_config(cfg)
    state = init_params(cfg, torch.Generator().manual_seed(0))
    if args.init_from:
        state = load_snapshot(args.init_from)
        print(f"initialized from {args.init_from}", flush=True)
    desc, pose = train_models(cfg, state, dev)
    os.makedirs(args.out, exist_ok=True)
    save_snapshot_config(args.out, cfg)

    def make_pool(n, seed, knobs=None):
        t0 = time.time()
        if args.hard:
            host = list(hard_training_stream(
                cfg, n, seed=seed, num_points=args.num_points,
                host_arrays=True, **(knobs or {})))
        else:
            host = list(synthetic_training_stream(
                cfg, n, seed=seed, num_points=args.num_points, overlap=0.8,
                host_arrays=True))
        pool = stack_batches(host, dev)          # one copy a key
        print(f"pool({n}, seed={seed}) ready in {time.time() - t0:.0f}s",
              flush=True)
        return pool

    with open(os.path.join(args.out, "scalars.jsonl"), "a") as scalars:
        def emit(stage, step, metrics, elapsed):
            rec = dict(stage=stage, step=step, elapsed_s=round(elapsed, 1),
                       **{k: round(v, 5) for k, v in metrics.items()})
            scalars.write(json.dumps(rec) + "\n")
            scalars.flush()

        def run_stage(stage, model, frozen, steps, phases):
            opt = make_optimizer(cfg, stage, steps_per_epoch=max(steps // 4, 1))
            step_fn = make_train_step(cfg, stage, opt)
            opt_state = opt.init(dict(model.named_parameters()))
            gen = torch.Generator(dev).manual_seed(1)
            # collapse rescue; detect_crash=False: a curriculum's phase
            # changes drop desc_acc below any fixed floor legitimately
            guard = CollapseGuard(detect_crash=False) if stage == "Desc" \
                else None
            fallback = {k: v.detach().cpu().clone()
                        for k, v in model.state_dict().items()}
            t0, gstep = time.time(), 0
            for pi, (n_steps, knobs) in enumerate(phases):
                pool = make_pool(args.pool, args.seed + 1009 * pi, knobs)
                if knobs:
                    print(f"[{stage}] phase {pi}: {n_steps} steps, "
                          f"overlap={knobs.get('overlap_range')}", flush=True)
                for _ in range(n_steps):
                    batch = pool_batch(pool, gstep % args.pool)
                    draws = make_train_draws(statics, cfg.capacity.max_points,
                                             gen, dev)
                    if stage == "Desc":
                        opt_state, m = step_fn(model, opt_state, batch, draws)
                    else:
                        opt_state, m = step_fn(model, opt_state, frozen,
                                               batch, draws)
                    if gstep % LOG_EVERY == 0 or gstep == steps - 1:
                        md = {k: float(v) for k, v in m.items()}
                        emit(stage, gstep, md, time.time() - t0)
                        print(f"[{stage} {gstep:6d}] " + " ".join(
                            f"{k}:{v:.4f}" for k, v in sorted(md.items()))
                            + f" ({time.time() - t0:.0f}s)", flush=True)
                        if guard is not None and guard.update(
                                gstep, md, model.state_dict()):
                            print(f"[{stage}] COLLAPSE at step {gstep}: "
                                  "restoring the last good state from step "
                                  f"{guard.last_good_step}", flush=True)
                            model.load_state_dict(guard.restore(fallback))
                            return model
                    gstep += 1
                del pool
            return model

        desc_phases, pose_phases = _stage_phases(args)
        desc = run_stage("Desc", desc, None, args.steps, desc_phases)
        save_params(os.path.join(args.out, "Desc", "best.msgpack"), desc)
        pose = run_stage("Pose", pose, desc, args.pose_steps, pose_phases)
        save_params(os.path.join(args.out, "Pose", "best.msgpack"), pose)
    print("saved to", args.out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
