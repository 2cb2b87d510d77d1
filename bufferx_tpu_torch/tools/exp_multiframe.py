"""Multi-frame front end at scale: a synthetic loop trajectory through a
hardsynth room, odometry edges and loop closures registered, every frame
pose refined by the pose-graph Gauss-Newton.

The port's counterpart of ``scripts/exp_multiframe.py``, with its flags,
trajectory, frame clouds (the port's ``data/hardsynth.py`` gives the same
arrays), configuration and protocol: one untimed run, then the timed one.
It prints one JSON line: per-edge registration recall, the absolute
trajectory error (ATE) of the chained odometry and of the refined poses,
the registration wall time and pairs/s, the device and the world size.

    python3 -m bufferx_tpu_torch.tools.exp_multiframe [--frames 50]
    python3 -m bufferx_tpu_torch.tools.exp_multiframe --device cpu \\
        --frames 4 --virtual-devices 2       # 2 gloo ranks on the CPU
    torchrun --nproc-per-node N -m bufferx_tpu_torch.tools.exp_multiframe

With more than one rank (``torchrun``: one card a rank over NCCL; or
``--virtual-devices`` gloo ranks on the CPU) the edges are sharded over the
ranks and rank 0 prints the line. A card run never drops to the CPU or to
gloo.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.data.hardsynth import eval_scene, sample_scene
from bufferx_tpu_torch.device import resolve_device
from bufferx_tpu_torch.parallel.mesh import make_mesh, spawn
from bufferx_tpu_torch.parallel.posegraph import chain_initialization
from bufferx_tpu_torch.pipeline.multiframe import (
    build_pose_graph,
    register_sequence,
)
from bufferx_tpu_torch.pipeline.registration import (
    PipelineStatics,
    build_models,
    init_params,
)
from bufferx_tpu_torch.train.trainer import compose_staged_params

__all__ = ["make_trajectory", "frame_cloud", "ate", "parse_args", "setup",
           "run_sequence", "summarize", "main"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_trajectory(num_frames: int, radius: float, rs) -> list:
    """Loop trajectory: frames walk a circle with yaw following the path
    (world-from-frame [4, 4] poses; frame k looks along the walk)."""
    poses = []
    for k in range(num_frames):
        th = 2.0 * np.pi * k / num_frames
        c, s = np.cos(th), np.sin(th)
        T = np.eye(4, dtype=np.float64)
        T[:3, 3] = [radius * c, radius * s, 0.4 + 0.05 * np.sin(3 * th)]
        yaw = th + np.pi / 2 + rs.uniform(-0.02, 0.02)
        cy, sy = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
        poses.append(T)
    return poses


def frame_cloud(prims, pose, rs, num_points, view_radius, noise):
    """One frame's scan: a fresh surface sample, cropped to a view ball
    around the sensor, in the frame's local coordinates."""
    world = sample_scene(prims, rs, num_points * 3)
    d = np.linalg.norm(world - pose[:3, 3], axis=1)
    keep = world[d < view_radius]
    if len(keep) > num_points:
        keep = keep[rs.choice(len(keep), num_points, replace=False)]
    inv = np.linalg.inv(pose)
    local = keep @ inv[:3, :3].T + inv[:3, 3]
    return (local + rs.randn(*local.shape) * noise).astype(np.float32)


def ate(poses_est, poses_gt):
    """(RMS, max) translation error after anchoring frame 0 (the estimate
    is anchored at the identity already)."""
    g0 = np.linalg.inv(poses_gt[0])
    errs = [np.linalg.norm(np.asarray(Te)[:3, 3] - (g0 @ Tg)[:3, 3])
            for Te, Tg in zip(poses_est, poses_gt)]
    return float(np.sqrt(np.mean(np.square(errs)))), float(np.max(errs))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--num-points", type=int, default=4096)
    ap.add_argument("--extent", type=float, default=6.0)
    ap.add_argument("--radius", type=float, default=1.6)
    ap.add_argument("--view-radius", type=float, default=3.5)
    ap.add_argument("--noise", type=float, default=0.005)
    ap.add_argument("--loop-every", type=int, default=10,
                    help="add a loop-closure edge (k, k-loop_every+1) "
                         "plus the big (last, first) closure")
    ap.add_argument("--checkpoint-dir", default="snapshot/hard_moments_r4ft2")
    ap.add_argument("--gn-iters", type=int, default=15)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (the JAX script's --cpu is "
                         "--device cpu)")
    ap.add_argument("--virtual-devices", type=int, default=0,
                    help="with --device cpu: gloo ranks to spawn")
    ap.add_argument("--profile", action="store_true",
                    help="on the card: run the timed run under the profiler "
                         "and add its device time, idle share and launches "
                         "to the line (the registration time then includes "
                         "the profiler's overhead)")
    return ap.parse_args(argv)


def setup(args, device) -> dict:
    """Configuration, models, ground-truth trajectory, frame clouds and
    edges, as the JAX script builds them."""
    dev = resolve_device(device)
    cfg = make_cfg("3DMatch").override(
        data=dict(root=""),
        capacity=dict(max_points=args.num_points,
                      num_ransac_hypotheses=2048, ransac_chunk=512,
                      sphere_query_chunk=64),
        patch=dict(num_fps=512, num_points_radius_estimate=512,
                   num_points_per_patch=256, desc_mode="moments"),
        test=dict(pose_refine=True),
    )
    ckpt = args.checkpoint_dir
    if ckpt and os.path.isdir(ckpt):
        params = compose_staged_params(
            os.path.join(ckpt, "Desc", "best.msgpack"),
            os.path.join(ckpt, "Pose", "best.msgpack"))
        log(f"checkpoint: {ckpt}")
    else:
        params = init_params(cfg, torch.Generator().manual_seed(0))
    models = build_models(PipelineStatics.from_config(cfg), params, dev)
    rs = np.random.RandomState(args.seed)
    prims = eval_scene(rs, extent=args.extent)
    poses_gt = make_trajectory(args.frames, args.radius, rs)
    clouds = [frame_cloud(prims, T, rs, args.num_points, args.view_radius,
                          args.noise) for T in poses_gt]
    loops = [(k, k - args.loop_every + 1)
             for k in range(args.loop_every - 1, args.frames,
                            args.loop_every)]
    loops.append((args.frames - 1, 0))
    edges = [(i, i + 1) for i in range(args.frames - 1)] + loops
    return dict(cfg=cfg, models=models, dev=dev, poses_gt=poses_gt,
                clouds=clouds, loops=loops, edges=edges)


def run_sequence(s: dict, args, use_mesh: bool = False):
    """One ``register_sequence`` over the setup's frames, with draws from a
    generator seeded ``--seed`` on the device; returns after the device is
    done."""
    dev = s["dev"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    result = register_sequence(
        s["cfg"], s["clouds"], s["models"], generator=gen,
        loop_closures=s["loops"], is_aligned=False, gn_iters=args.gn_iters,
        use_mesh=use_mesh, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return result


def summarize(s: dict, args, result, reg_s: float, world_size: int) -> dict:
    """The JSON line's fields from a run's result."""
    cfg, poses_gt, edges = s["cfg"], s["poses_gt"], s["edges"]
    pair_poses = torch.stack([r.pose for r in result.pair_results]).cpu()
    inliers = torch.stack([r.num_inliers for r in result.pair_results]).cpu()
    ok = 0
    for (i, j), pose, n_in in zip(edges, pair_poses, inliers.tolist()):
        T_gt = torch.from_numpy(
            (np.linalg.inv(poses_gt[j]) @ poses_gt[i]).astype(np.float32))
        rte = float(se3.compute_rte(pose, T_gt))
        rre = float(se3.compute_rre(pose, T_gt))
        good = rte < cfg.test.rte_thresh and rre < cfg.test.rre_thresh
        ok += int(good)
        if not good:
            log(f"  edge ({i},{j}) FAILED: rte {rte:.3f} rre {rre:.2f} "
                f"inl {n_in}")
    n_odo = args.frames - 1
    odo = build_pose_graph(edges[:n_odo], pair_poses[:n_odo],
                           inliers[:n_odo], device="cpu")
    ate_chain, _ = ate(chain_initialization(odo, args.frames).numpy(),
                       poses_gt)
    ate_gn, max_gn = ate(result.poses.cpu().numpy(), poses_gt)
    dev = s["dev"]
    return dict(
        metric="multiframe_ate_rmse_m", frames=args.frames, edges=len(edges),
        devices=world_size, edge_recall=ok / len(edges),
        edges_registered=ok, ate_chained=ate_chain, ate_refined=ate_gn,
        ate_max_refined=max_gn, value=ate_gn, registration_s=reg_s,
        pairs_per_s=len(edges) / reg_s,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        world_size=world_size)


def _run(args, device, mesh=None) -> dict:
    world = 1 if mesh is None else mesh.world_size
    s = setup(args, device if mesh is None else mesh.device)
    log(f"{args.frames} frames, {args.frames - 1} odometry edges, "
        f"{len(s['loops'])} loop closures, {world} rank(s) on {s['dev']}")
    t0 = time.perf_counter()
    run_sequence(s, args, world > 1)
    log(f"warm-up run: {time.perf_counter() - t0:.1f} s")
    profile = None
    t0 = time.perf_counter()
    if args.profile and s["dev"].type == "cuda":
        from bufferx_tpu_torch.tools.trace_pair import _profiled

        out = {}
        with contextlib.redirect_stdout(sys.stderr):   # one line on stdout
            profile, _ = _profiled(
                lambda: out.setdefault("r", run_sequence(s, args, world > 1)),
                "multi-frame sequence", 1)
        result = out["r"]
    else:
        result = run_sequence(s, args, world > 1)
    reg_s = time.perf_counter() - t0
    summary = summarize(s, args, result, reg_s, world)
    if profile is not None:
        summary["profile"] = profile
    return summary


def _rank_main(mesh, args) -> dict:
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // mesh.world_size))
    return _run(args, "cpu", mesh)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.virtual_devices:
        if args.device != "cpu":
            raise SystemExit("--virtual-devices spawns gloo ranks: it needs "
                             "--device cpu (on cards, start one rank a card "
                             "with torchrun)")
        summary = spawn(_rank_main, args.virtual_devices, "cpu",
                        args=(args,))[0]
    elif "WORLD_SIZE" in os.environ:
        mesh = make_mesh(device=args.device)
        try:
            summary = _run(args, args.device, mesh)
        finally:
            dist.destroy_process_group()
        if mesh.rank != 0:
            return 0
    else:
        summary = _run(args, args.device)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
