"""Two-stage training CLI: the port of ``scripts/train.py``.

    python3 -m bufferx_tpu_torch.tools.train --dataset 3DMatch \\
        --root ../datasets/ThreeDMatch
    python3 -m bufferx_tpu_torch.tools.train --dataset KITTI \\
        --root ../datasets/kitti --stages Desc Pose --epochs 50
    python3 -m bufferx_tpu_torch.tools.train --dataset Synthetic --cpu \\
        --epochs 1 --steps-per-epoch 4              # no data, on the CPU

Each stage trains with the other stage's latest weights frozen (the Pose
stage reads the Desc stage's result); snapshots land in
``snapshot/<dataset>/<experiment>/<stage>/`` as flax msgpack that both
packages read (:class:`~bufferx_tpu_torch.train.trainer.Trainer`).
``--pretrain DIR`` warm-starts from ``DIR/{Desc,Pose}/best.msgpack``.

On a dataset the train and val streams draw from one ``RandomState`` seeded
with ``cfg.data.manual_seed``, as the JAX script's do: each epoch takes a
seed for its correspondence generator, then a permutation of the split,
and builds ``build_training_batch`` on each sample in that order. The JAX
script's ``jax.random`` draws become a ``torch.Generator``'s: the
correspondence noise of each batch from the stream's generator, and the
step's :class:`~bufferx_tpu_torch.train.forward.TrainDraws` from the
trainer's. It runs on the card; ``--cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

__all__ = ["parse_args", "dataset_stream", "main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--dataset", default="3DMatch",
                    choices=["3DMatch", "KITTI", "Synthetic"])
    ap.add_argument("--root", default="")
    ap.add_argument("--experiment-id", default="bufferx_tpu")
    ap.add_argument("--stages", nargs="+", default=["Desc", "Pose"])
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--steps-per-epoch", type=int, default=200)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--pretrain", default="",
                    help="snapshot dir to warm start from")
    return ap.parse_args(argv)


def dataset_stream(cfg, ds, n: int, rs: np.random.RandomState, device):
    """A factory of one pass over ``n`` samples of ``ds`` in an order drawn
    from ``rs`` (one pass a call, as the trainer calls it once an epoch)."""
    from bufferx_tpu_torch.data.training import build_training_batch

    def gen():
        generator = torch.Generator(device).manual_seed(
            int(rs.randint(1 << 31)))
        order = rs.permutation(len(ds))[:n]
        for idx in order:
            s = ds[int(idx)]
            yield build_training_batch(
                cfg, s["src_points"], s["tgt_points"], s["relt_pose"], rs,
                generator, device=device,
            )

    return gen


def main(argv=None, log=print) -> int:
    args = parse_args(argv)
    from bufferx_tpu_torch.config import make_cfg
    from bufferx_tpu_torch.data.training import synthetic_training_stream
    from bufferx_tpu_torch.device import resolve_device
    from bufferx_tpu_torch.pipeline.registration import init_params
    from bufferx_tpu_torch.tools.weights import (
        DESC_MODULES,
        POSE_MODULES,
        read_checkpoint,
    )
    from bufferx_tpu_torch.train.trainer import Trainer, train_models

    dev = resolve_device("cpu" if args.cpu else "cuda")
    name = "ModelNet40" if args.dataset == "Synthetic" else args.dataset
    cfg = make_cfg(name, args.root)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    snap_dir = os.path.join("snapshot", args.dataset, args.experiment_id)

    if args.pretrain:
        for stage, key, modules in (("Desc", "desc", DESC_MODULES),
                                    ("Pose", "pose", POSE_MODULES)):
            p = os.path.join(args.pretrain, stage, "best.msgpack")
            if os.path.exists(p):
                params[key] = read_checkpoint(p, modules)
                log(f"warm start {stage} from {p}")

    n_val = max(args.steps_per_epoch // 10, 2)
    if args.dataset == "Synthetic":
        def train_batches():
            return synthetic_training_stream(
                cfg, args.steps_per_epoch, seed=1, num_points=4000,
                device=dev)

        def val_batches():
            return synthetic_training_stream(
                cfg, n_val, seed=999, num_points=4000, device=dev)
    else:
        from bufferx_tpu_torch.data.datasets import get_dataset

        rs = np.random.RandomState(cfg.data.manual_seed)
        train_batches = dataset_stream(cfg, get_dataset(cfg, "train"),
                                       args.steps_per_epoch, rs, dev)
        val_batches = dataset_stream(cfg, get_dataset(cfg, "val"), n_val, rs,
                                     dev)

    desc, pose = train_models(cfg, params, dev)
    models = {"Desc": desc, "Pose": pose}
    for stage in args.stages:
        frozen = models["Desc"] if stage == "Pose" else None
        trainer = Trainer(
            cfg.override(stage=stage), stage, models[stage], frozen,
            train_batches, val_batches,
            steps_per_epoch=args.steps_per_epoch, snapshot_dir=snap_dir,
            log=log,
        )
        models[stage] = trainer.train(args.epochs)
    log(f"done; snapshots in {snap_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
