"""Write 3DMatch-layout datasets made of hardsynth pairs.

    python3 -m bufferx_tpu_torch.tools.hard_layout --out DIR [--pairs 8] \\
        [--num-points 260000] [--train-pairs 2]

Gives the dataset entry points (``tools/evaluate.py --dataset 3DMatch``,
``tools/train.py --dataset 3DMatch``) data to read where no benchmark is at
hand. ``DIR/test/3DMatch`` holds one scene of the 3DMatch test benchmark
(its first scene name): pair k is a ``hard_pair`` of the held-out eval
scene family, written as binary PLY fragments ``cloud_bin_k`` and
``cloud_bin_{pairs + k}`` (fragments more than one apart, so the RMSE
protocol scores them), with ``gt.log`` (the pose whose inverse maps the
source onto the target, as the loader reads it) and a ``gt.info`` of
scaled identities. ``DIR/train`` holds the 3DMatch training manifest:
``train_pairs`` pairs of the training family in scene ``hard-train`` and
as many in ``hard-val``, each fragment with its world pose
(``.pose.npy``), the overlap pickle and both split lists. Everything comes
from ``RandomState(seed)``: the same arguments write the same files.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

from bufferx_tpu_torch.data import splits
from bufferx_tpu_torch.data.base import write_trajectory_log
from bufferx_tpu_torch.data.hardsynth import hard_pair
from bufferx_tpu_torch.data.io import save_ply

__all__ = ["write_test_scene", "write_train_manifest", "main"]

# a 6x6 information matrix of the gt.info files: the RMSE protocol then
# reads |t error|^2 + |q_imag error|^2 against 0.2^2
INFO_SCALE = 100.0


def write_test_scene(root: str, pairs: int = 8, num_points: int = 260000,
                     overlap: float = 0.7, noise: float = 0.005,
                     seed: int = 0) -> str:
    """The test benchmark's first scene under ``root``; returns its name."""
    scene = splits.THREEDMATCH_TEST_SCENES[0]
    base = os.path.join(root, "test", "3DMatch")
    frag_dir = os.path.join(base, "fragments", scene)
    rs = np.random.RandomState(seed)
    rows, poses = [], []
    for k in range(pairs):
        src, tgt, T = hard_pair(rs, family="eval", num_points=num_points,
                                overlap_ratio=overlap, noise=noise)
        save_ply(os.path.join(frag_dir, f"cloud_bin_{k}.ply"), src)
        save_ply(os.path.join(frag_dir, f"cloud_bin_{pairs + k}.ply"), tgt)
        rows.append([k, pairs + k, 2 * pairs])
        poses.append(np.linalg.inv(np.asarray(T, np.float64)))
    gt_dir = os.path.join(base, "gt_result", scene)
    write_trajectory_log(os.path.join(gt_dir, "gt.log"), rows, poses)
    with open(os.path.join(gt_dir, "gt.info"), "w") as f:
        for i, j, n in rows:
            f.write(f"{i}\t{j}\t{n}\n")
            for r in range(6):
                f.write("\t".join(f"{INFO_SCALE * (r == c):.1f}"
                                  for c in range(6)) + "\n")
    return scene


def write_train_manifest(root: str, pairs: int = 2, num_points: int = 60000,
                         overlap: float = 0.7, seed: int = 1) -> None:
    """The training manifest under ``root/train``: scenes ``hard-train`` and
    ``hard-val`` with ``pairs`` pairs each."""
    train = os.path.join(root, "train")
    rs = np.random.RandomState(seed)
    manifest = {}
    for split, scene in (("train", "hard-train"), ("val", "hard-val")):
        for k in range(pairs):
            src, tgt, T = hard_pair(rs, family="train", num_points=num_points,
                                    overlap_ratio=overlap)
            ids = [f"{scene}/seq-01/cloud_bin_{2 * k + e}" for e in (0, 1)]
            # world poses: the source's is the identity, the target's the
            # inverse of T, so that inv(tgt_pose) @ src_pose = T
            world = (np.eye(4), np.linalg.inv(np.asarray(T, np.float64)))
            for fid, pts, pose in zip(ids, (src, tgt), world):
                save_ply(os.path.join(train, fid + ".ply"), pts)
                np.save(os.path.join(train, fid + ".pose.npy"), pose)
            manifest[f"{ids[0]}@{ids[1]}"] = overlap
        with open(os.path.join(train, f"{split}_3dmatch.txt"), "w") as f:
            f.write(scene + "\n")
    with open(os.path.join(train, "3DMatch_train_overlap.pkl"), "wb") as f:
        pickle.dump(manifest, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--num-points", type=int, default=260000)
    ap.add_argument("--train-pairs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    scene = write_test_scene(args.out, args.pairs, args.num_points,
                             seed=args.seed)
    write_train_manifest(args.out, args.train_pairs, seed=args.seed + 1)
    print(f"wrote {args.pairs} test pairs of scene {scene} and "
          f"{args.train_pairs} + {args.train_pairs} training pairs under "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
