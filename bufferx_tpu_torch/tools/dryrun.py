"""Entry points for a harness: one pair on the card, and a dry run of the
distributed layer over ranks.

The port's counterpart of ``__graft_entry__.py``:

- :func:`entry` returns ``(fn, example_args)``: the whole registration of
  one pair (:func:`register_pair`) at small capacities, with random weights
  from a seeded generator, on the card (or ``device="cpu"``);
- :func:`dryrun_multichip` starts ``n_devices`` ranks (one card each over
  NCCL, or gloo ranks with ``device="cpu"``) and runs, at tiny shapes, the
  data-parallel Desc-stage training step (gradients and BatchNorm
  statistics averaged over the ranks), the pair-sharded evaluation and the
  factor-sharded pose-graph Gauss-Newton, with ``__graft_entry__.py``'s
  asserts.

    python3 -m bufferx_tpu_torch.tools.dryrun [--devices N] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu_torch.data.training import build_training_batch
from bufferx_tpu_torch.device import resolve_device
from bufferx_tpu_torch.parallel import (
    PoseGraph,
    chain_initialization,
    make_sharded_eval,
    make_sharded_train_step,
    pose_graph_gauss_newton,
    spawn,
)
from bufferx_tpu_torch.parallel.sharded import adam
from bufferx_tpu_torch.pipeline.registration import (
    Cloud,
    PipelineStatics,
    build_models,
    init_params,
    prepare_cloud,
    register_pair,
)
from bufferx_tpu_torch.train.forward import TrainStatics, make_train_draws
from bufferx_tpu_torch.train.trainer import train_models

__all__ = ["demo_cfg", "dryrun_cfg", "entry", "dryrun_multichip"]


def demo_cfg():
    """``__graft_entry__.py``'s small configuration."""
    return make_cfg("ModelNet40").override(
        capacity=dict(max_points=2048, num_ransac_hypotheses=1024,
                      ransac_chunk=256, sphere_query_chunk=64),
        patch=dict(num_fps=256, num_points_radius_estimate=256,
                   num_points_per_patch=128, num_scales=2,
                   search_radius_thresholds=(5.0, 2.0)),
        train=dict(pos_num=64),
    )


def dryrun_cfg():
    """The dry run's tiny shapes (``__graft_entry__.py``'s): they check the
    sharding and the collectives, not quality."""
    return demo_cfg().override(
        capacity=dict(max_points=512, num_ransac_hypotheses=128,
                      ransac_chunk=64, sphere_query_chunk=16),
        patch=dict(num_fps=48, num_points_radius_estimate=64,
                   num_points_per_patch=32, num_scales=1,
                   search_radius_thresholds=(5.0,)),
        train=dict(pos_num=16),
    )


def entry(device="cuda"):
    """Returns (fn, example_args): ``fn(src_xyz, src_mask, tgt_xyz,
    tgt_mask, aligned, generator)`` registers one pair with every scale."""
    dev = resolve_device(device)
    cfg = demo_cfg()
    statics = PipelineStatics.from_config(cfg)
    models = build_models(
        statics, init_params(cfg, torch.Generator().manual_seed(0)), dev)
    rs = np.random.RandomState(0)
    src_pts, tgt_pts, _ = synthetic_pair_full_overlap(rs, num_points=2500)
    src = prepare_cloud(src_pts, cfg, seed=0, device=dev)
    tgt = prepare_cloud(tgt_pts, cfg, seed=0, device=dev)

    def fn(src_xyz, src_mask, tgt_xyz, tgt_mask, aligned, generator):
        return register_pair(cfg, Cloud(src_xyz, src_mask),
                             Cloud(tgt_xyz, tgt_mask), models,
                             generator=generator, is_aligned=bool(aligned),
                             device=dev)

    example_args = (src.xyz, src.mask, tgt.xyz, tgt.mask, False,
                    torch.Generator().manual_seed(0))
    return fn, example_args


def _ring_graph(k: int, n_ranks: int, rank: int, device) -> tuple:
    """``__graft_entry__.py``'s 6-frame chain with a (0, k-1) closure,
    padded with weight-0 factors to a multiple of ``n_ranks``: (the whole
    graph, this rank's shard)."""
    rs = np.random.RandomState(7)
    ei = list(range(k - 1)) + [0]
    ej = list(range(1, k)) + [k - 1]
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(1, k):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rs.randn(3)
        gt.append(gt[-1] @ T)
    tms = [np.linalg.inv(gt[a]) @ gt[b] for a, b in zip(ei, ej)]
    e = len(ei)
    pad = (-e) % n_ranks
    graph = PoseGraph(
        torch.tensor(ei + [0] * pad, device=device),
        torch.tensor(ej + [0] * pad, device=device),
        torch.from_numpy(np.concatenate(
            [np.stack(tms), np.tile(np.eye(4, dtype=np.float32),
                                    (pad, 1, 1))]).astype(np.float32)
        ).to(device),
        torch.tensor([1.0] * e + [0.0] * pad, device=device))
    n = (e + pad) // n_ranks
    return graph, PoseGraph(*(x[rank * n:(rank + 1) * n] for x in graph))


def _dryrun_rank(mesh) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    dev, n = mesh.device, mesh.world_size
    cfg = dryrun_cfg()
    state = init_params(cfg, torch.Generator().manual_seed(0))

    # ---- the training step, data-parallel: gradients and BN statistics
    # averaged over the ranks; sample r lives on rank r
    desc, _ = train_models(cfg, state, dev, bn_group=mesh)
    opt = adam(1e-3)
    step = make_sharded_train_step(cfg, mesh, opt)
    rs = np.random.RandomState(mesh.rank)
    s, t, T = synthetic_pair_full_overlap(rs, num_points=700)
    gen = torch.Generator(device=dev).manual_seed(mesh.rank)
    batch = build_training_batch(cfg, s, t, T, rs, generator=gen, device=dev)
    draws = make_train_draws(TrainStatics.from_config(cfg),
                             cfg.capacity.max_points, gen, dev)
    opt_state = opt.init(dict(desc.named_parameters()))
    _, metrics = step(desc, opt_state, [batch], [draws])
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError("sharded train loss not finite")

    # ---- pair-sharded evaluation over the same ranks
    eval_fn = make_sharded_eval(state, cfg, mesh)
    srcs, tgts = [], []
    for i in range(n):
        s, t, _ = synthetic_pair_full_overlap(np.random.RandomState(100 + i),
                                              num_points=700)
        srcs.append(prepare_cloud(s, cfg, seed=i, device=dev))
        tgts.append(prepare_cloud(t, cfg, seed=i, device=dev))
    res = eval_fn(srcs, tgts, generator=torch.Generator().manual_seed(1),
                  is_aligned=False)
    if tuple(res.pose.shape) != (n, 4, 4):
        raise AssertionError(f"sharded eval poses {tuple(res.pose.shape)}")

    # ---- factor-sharded pose-graph GN (normal equations all-reduced)
    graph, local = _ring_graph(6, n, mesh.rank, dev)
    out = pose_graph_gauss_newton(local, chain_initialization(graph, 6),
                                  num_poses=6, num_iters=3, mesh=mesh)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("sharded pose-graph GN not finite")
    return dict(loss=loss, pose=res.pose.cpu(), gn=out.cpu(),
                device=str(dev), backend=torch.distributed.get_backend())


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Run the training step, the sharded eval and the sharded GN over
    ``n_devices`` ranks; returns each rank's results (loss, poses, GN poses,
    device, backend)."""
    out = spawn(_dryrun_rank, n_devices, device)
    print(f"dryrun_multichip({n_devices}): train step + sharded eval + "
          f"pose-graph GN ran on {out[0]['backend']} ranks.", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks (default: the cards of this host; 2 on the "
                         "CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    dev = resolve_device(args.device)
    fn, example = entry(dev)
    out = fn(*example)
    print("entry() pose:\n", out.pose.cpu().numpy(), flush=True)
    n = args.devices or (torch.cuda.device_count() if dev.type == "cuda"
                         else 2)
    dryrun_multichip(n, dev.type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
