"""Multi-frame front end: a scan sequence -> registrations -> pose graph.

Counterpart of :mod:`bufferx_tpu.pipeline.multiframe`: register the
odometry pairs (and loop closures) of a sequence, turn them into
relative-pose factors weighted by the solver's confidence, and refine all
frame poses jointly with the pose-graph Gauss-Newton layer
(:mod:`bufferx_tpu_torch.parallel.posegraph`). With a process group of
several ranks the pairs are sharded over them
(:func:`~bufferx_tpu_torch.parallel.sharded.make_sharded_eval`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from bufferx_tpu_torch.config import Config
from bufferx_tpu_torch.device import resolve_device
from bufferx_tpu_torch.parallel.mesh import make_mesh
from bufferx_tpu_torch.parallel.posegraph import (
    PoseGraph,
    chain_initialization,
    pose_graph_gauss_newton,
)
from bufferx_tpu_torch.parallel.sharded import make_sharded_eval
from bufferx_tpu_torch.pipeline.registration import (
    Models,
    PipelineStatics,
    RegistrationResult,
    _default_generator,
    build_models,
    prepare_cloud,
    register_pair,
    register_pairs_batched,
)

__all__ = ["MultiFrameResult", "build_pose_graph", "register_sequence"]


class MultiFrameResult(NamedTuple):
    poses: torch.Tensor          # [K, 4, 4] world-from-frame
    graph: PoseGraph
    pair_results: list           # per-factor RegistrationResult


def build_pose_graph(edges: Sequence[tuple], measurements, num_inliers,
                     min_inliers: int = 5, device="cuda") -> PoseGraph:
    """Registration outputs -> weighted factors on ``device``.

    A pair measuring ``tgt ~ T_ij @ src`` constrains ``T_j ~ T_i @
    inv(T_ij)`` under the world-from-frame convention, so the factor's
    measurement is ``inv(T_ij)`` (float32). Its weight is sqrt(num_inliers),
    0 below ``min_inliers`` (a failed registration stays out of the graph).
    ``measurements`` [E, 4, 4] and ``num_inliers`` [E]: tensors (read where
    they are: no host read) or host sequences.
    """
    dev = resolve_device(device)
    meas = torch.as_tensor(np.asarray(measurements) if not torch.is_tensor(
        measurements) else measurements).to(dev, torch.float32)
    if not torch.is_tensor(num_inliers):
        num_inliers = torch.as_tensor(np.asarray(num_inliers))
    n = num_inliers.to(dev, torch.float32)
    edges = torch.as_tensor(np.asarray(edges, np.int64).reshape(-1, 2)).to(dev)
    return PoseGraph(
        edges[:, 0], edges[:, 1], torch.linalg.inv_ex(meas)[0],
        torch.where(n >= min_inliers, torch.sqrt(n), 0.0))


def register_sequence(
    cfg: Config,
    clouds: Sequence[np.ndarray],
    params,
    generator: torch.Generator | None = None,
    loop_closures: Sequence[tuple] = (),
    is_aligned: bool = False,
    gn_iters: int = 10,
    use_mesh: bool = False,
    robust: str | None = "huber",
    robust_scale: float = 0.3,
    batch_size: int = 8,
    *,
    draws=None,
    device="cuda",
) -> MultiFrameResult:
    """Registers consecutive frames (and the loop closures) and runs the
    pose-graph GN. Returns world-from-frame poses with frame 0 anchored.

    ``robust``/``robust_scale`` set the pose graph's IRLS kernel ("huber",
    "gm" or "none"; the 0.3 default is in chordal-residual units, tuned on
    room-scale indoor sequences). ``robust=None`` raises ``ValueError`` from
    the pose graph, as in the JAX package (whose docstring says it turns
    the reweighting off; its code does not).

    The edges are registered by one of three paths, as in the JAX package:

    - ``use_mesh`` with a process group of more than one rank: the edges
      are sharded over the ranks (:func:`make_sharded_eval`: every scale,
      draws made for all edges before sharding; ``draws``: a
      :class:`Draws` with a leading E); every rank gets every result and
      runs the same GN;
    - ``batch_size > 1``: two-phase batched serving
      (:func:`register_pairs_batched`; ``draws``: its per-batch pairs);
    - ``batch_size == 1``: one :func:`register_pair` an edge (``draws``:
      one pair's draws an edge).

    Frame ``i`` is prepared with seed ``i``; the draws come from
    ``generator`` (a CPU generator seeded 0 if None) unless given.
    """
    mesh = None
    if use_mesh and dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_mesh(device=device)      # this rank's card under NCCL
    dev = resolve_device(device) if mesh is None else mesh.device
    statics = PipelineStatics.from_config(cfg)
    k = len(clouds)
    prepared = [prepare_cloud(c, cfg, seed=i, device=dev)
                for i, c in enumerate(clouds)]
    edges = [(i, i + 1) for i in range(k - 1)] + list(loop_closures)
    models = params if isinstance(params, Models) else build_models(
        statics, params, dev)
    srcs = [prepared[i] for i, _ in edges]
    tgts = [prepared[j] for _, j in edges]

    if mesh is not None:
        batch = make_sharded_eval(models, cfg, mesh)(
            srcs, tgts, draws=draws, generator=generator,
            is_aligned=is_aligned)
        results = [RegistrationResult(*(x[n] for x in batch))
                   for n in range(len(edges))]
    elif batch_size > 1:
        results = register_pairs_batched(
            cfg, srcs, tgts, models, batch_size=batch_size,
            generator=generator, draws=draws, is_aligned=is_aligned,
            device=dev)
    else:
        generator = _default_generator(generator)
        results = [register_pair(
            cfg, s, t, models, generator=generator,
            draws=None if draws is None else draws[n],
            is_aligned=is_aligned, device=dev)
            for n, (s, t) in enumerate(zip(srcs, tgts))]

    graph = build_pose_graph(
        edges, torch.stack([r.pose for r in results]),
        torch.stack([r.num_inliers for r in results]), device=dev)
    init = chain_initialization(graph, k)
    # Huber IRLS by default: real sequences hold failed or outlier edges
    # (low-overlap loop closures), and one bad measurement would drag every
    # pose under plain GN
    poses = pose_graph_gauss_newton(
        graph, init, num_poses=k, num_iters=gn_iters, robust=robust,
        robust_scale=robust_scale)
    return MultiFrameResult(poses=poses, graph=graph, pair_results=results)
