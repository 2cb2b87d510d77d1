"""Rank functions for ``tests/test_torch_parallel.py``: each runs in a gloo
rank started by ``bufferx_tpu_torch.parallel.spawn`` and imports the port
only (and numpy). Inputs arrive as numpy arrays; results leave as numpy
arrays."""

import dataclasses

import numpy as np
import torch

from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.parallel import bundle as tba
from bufferx_tpu_torch.parallel import posegraph as tpg
from bufferx_tpu_torch.parallel.sharded import (
    adam,
    make_sharded_eval,
    make_sharded_train_step,
)
from bufferx_tpu_torch.pipeline import multiframe as tmf
from bufferx_tpu_torch.pipeline import registration as treg
from bufferx_tpu_torch.tools.weights import load_snapshot
from bufferx_tpu_torch.train.forward import TrainDraws
from bufferx_tpu_torch.train.trainer import train_models


def f32_statics():
    """The pipeline's conv stacks in float32 (``use_bf16`` is a statics
    field that no configuration sets), in this process."""
    orig = treg.PipelineStatics.from_config
    treg.PipelineStatics.from_config = classmethod(
        lambda cls, cfg: dataclasses.replace(orig(cfg), use_bf16=False))


def shard(arrays, rank, world):
    """Rank ``rank``'s contiguous shard of equally long arrays."""
    n = len(arrays[0]) // world
    return [torch.from_numpy(np.asarray(a)[rank * n:(rank + 1) * n])
            for a in arrays]


def draws_of(d: dict):
    return treg.Draws(*(torch.from_numpy(d[k]) for k in treg.Draws._fields))


def checks(mesh, p: dict) -> dict:
    torch.set_num_threads(2)
    f32_statics()
    r, w = mesh.rank, mesh.world_size
    out = {"rank": r, "world_size": w, "device": str(mesh.device)}

    # mesh: more ranks than exist raise, and so do fewer; the whole world
    from bufferx_tpu_torch.parallel.mesh import make_mesh

    for label, n in (("too_many_raises", w + 1), ("too_few_raises", w - 1)):
        try:
            make_mesh(n, device="cpu")
        except ValueError:
            out[label] = True
    whole = make_mesh(w, device="cpu")
    out["whole"] = (whole.rank, whole.world_size)

    # factor-sharded GN
    g = p["gn"]
    local = tpg.PoseGraph(*shard([g["ei"], g["ej"], g["tm"], g["w"]], r, w))
    out["gn"] = tpg.pose_graph_gauss_newton(
        local, torch.from_numpy(g["init"]), num_poses=g["k"],
        num_iters=g["iters"], mesh=mesh, robust=g["robust"],
        robust_scale=g["robust_scale"]).numpy()

    # observation- and factor-sharded BA
    b = p["ba"]
    obs = tba.LandmarkGraph(*shard([b["of"], b["ol"], b["oz"], b["w"]], r, w))
    pg = tpg.PoseGraph(*shard([b["pg_ei"], b["pg_ej"], b["pg_tm"],
                               b["pg_w"]], r, w))
    poses, lms = tba.bundle_adjust(
        torch.from_numpy(b["poses0"]), torch.from_numpy(b["lms0"]), obs,
        num_poses=b["k"], num_lms=b["l"], pose_graph=pg,
        num_iters=b["iters"], mesh=mesh)
    out["ba"] = (poses.numpy(), lms.numpy())

    # pair-sharded evaluation (a ragged tail)
    cfg = make_cfg("ModelNet40").override(**p["cfg"])
    e = p["eval"]
    srcs = [treg.Cloud(torch.from_numpy(x), torch.from_numpy(m))
            for x, m in e["srcs"]]
    tgts = [treg.Cloud(torch.from_numpy(x), torch.from_numpy(m))
            for x, m in e["tgts"]]
    models = treg.build_models(treg.PipelineStatics.from_config(cfg),
                               load_snapshot(p["snapshot"]), "cpu")
    res = make_sharded_eval(models, cfg, mesh)(
        srcs, tgts, draws=draws_of(e["draws"]), is_aligned=False)
    out["eval"] = {k: v.numpy() for k, v in res._asdict().items()}

    # the sequence's sharded branch
    s = p["sequence"]
    seq = tmf.register_sequence(cfg, s["clouds"], models, use_mesh=True,
                                draws=draws_of(s["draws"]), gn_iters=5,
                                device="cpu")
    out["sequence"] = dict(poses=seq.poses.numpy(),
                           pairs=np.stack([x.pose.numpy()
                                           for x in seq.pair_results]))

    # the data-parallel Desc step: samples [r n, (r + 1) n) on rank r
    t = p["train"]
    n = len(t["batches"]) // w
    desc, _ = train_models(cfg, load_snapshot(p["snapshot"]), "cpu",
                           bn_group=mesh)
    opt = adam(t["lr"])
    step = make_sharded_train_step(cfg, mesh, opt)
    batches, draws = [], []
    for i in range(r * n, (r + 1) * n):
        bt = {k: torch.from_numpy(np.asarray(v))
              for k, v in t["batches"][i].items() if k != "is_aligned"}
        bt["is_aligned"] = bool(t["batches"][i]["is_aligned"])
        batches.append(bt)
        draws.append(TrainDraws(*(torch.from_numpy(x)
                                  for x in t["draws"][i])))
    _, metrics = step(desc, opt.init(dict(desc.named_parameters())),
                      batches, draws)
    out["train"] = dict(
        metrics={k: float(v) for k, v in metrics.items()},
        state={k: v.detach().numpy().copy()
               for k, v in desc.state_dict().items()})
    return out
