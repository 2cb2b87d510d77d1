"""Pair-sharded evaluation and data-parallel training over ranks.

Counterpart of :mod:`bufferx_tpu.parallel.sharded`, where ``shard_map``
splits a batch of pairs over the chips of a mesh axis. Here every rank of a
:class:`~bufferx_tpu_torch.parallel.mesh.Mesh` is a process with its own
device, the caller runs the same code on every rank, and the collectives
are ``torch.distributed``'s (NCCL on cards, gloo on the CPU):

- :func:`make_sharded_eval`: rank r registers the r-th contiguous shard of
  the pairs (the tail padded by repeating the last pair), and the results
  are all-gathered and the padding sliced off;
- :func:`make_sharded_train_step`: the data-parallel Desc-stage step, with
  BatchNorm statistics shared over the ranks, the loss averaged and the
  gradients all-reduced and averaged; the parameters stay replicated.

A pair's or a sample's random draws are its own (made before sharding, or
passed in), so a result does not depend on the world size.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bufferx_tpu_torch.config import Config
from bufferx_tpu_torch.models.layers import ConvBNRelu
from bufferx_tpu_torch.parallel.mesh import Mesh
from bufferx_tpu_torch.pipeline.registration import (
    Cloud,
    Draws,
    Models,
    PipelineStatics,
    RegistrationResult,
    ScaleDraws,
    _default_generator,
    build_models,
    make_draws,
    register_batch,
)
from bufferx_tpu_torch.train.forward import TrainStatics, desc_stage_loss
from bufferx_tpu_torch.train.trainer import Optimizer

__all__ = ["adam", "make_sharded_eval", "make_sharded_train_step"]


def _shard(x: torch.Tensor, lo: int, hi: int, size: int) -> torch.Tensor:
    """Rows [lo, hi) of ``x`` padded to ``size`` rows by repeating its last
    row (views and one concatenation: no host-to-device copy)."""
    rows = x[lo:hi]
    pad = size - rows.shape[0]
    return torch.cat([rows, x[-1:].expand((pad,) + x.shape[1:])]) if pad \
        else rows


def make_sharded_eval(params, cfg: Config, mesh: Mesh):
    """Returns ``eval_fn(srcs, tgts, draws=None, generator=None,
    is_aligned=None) -> RegistrationResult`` with a leading B = len(srcs),
    every rank holding all B results.

    Every rank passes the same pairs (clouds on ``mesh.device``) and the
    same draws: a :class:`Draws` (or :class:`ScaleDraws`) with a leading B,
    or none, and then every rank makes all B pairs' draws from its own
    ``generator`` (seed them alike). Rank r registers pairs [r n, (r + 1)
    n), n = ceil(B / world size), through :func:`register_batch` (every
    scale, the JAX ``register_pair_jit`` under ``vmap``); a ragged tail is
    padded by repeating the last pair, and the padded slots are sliced off
    the gathered result. ``params``: state dicts or :class:`Models`.
    ``is_aligned``: None, a bool, or a [B] bool tensor, sliced and padded
    like the draws.
    """
    statics = PipelineStatics.from_config(cfg)
    models = params if isinstance(params, Models) else build_models(
        statics, params, mesh.device)

    def eval_fn(srcs: Sequence[Cloud], tgts: Sequence[Cloud],
                draws: Draws | ScaleDraws | None = None,
                generator: torch.Generator | None = None,
                is_aligned: bool | torch.Tensor | None = None
                ) -> RegistrationResult:
        b = len(srcs)
        if len(tgts) != b or b == 0:
            raise ValueError(f"{b} sources and {len(tgts)} targets")
        if draws is None:
            draws = make_draws(statics, _default_generator(generator),
                               mesh.device, batch=b)
        n = -(-b // mesh.world_size)
        lo = min(mesh.rank * n, b)
        hi = min(lo + n, b)
        mine = list(range(lo, hi)) + [b - 1] * (n - (hi - lo))
        if isinstance(is_aligned, torch.Tensor) and is_aligned.ndim:
            is_aligned = _shard(is_aligned, lo, hi, n)   # [B] -> this rank's
        local = register_batch(
            cfg, [srcs[i] for i in mine], [tgts[i] for i in mine], models,
            draws=type(draws)(*(_shard(x, lo, hi, n) for x in draws)),
            is_aligned=is_aligned, device=mesh.device)

        def gather(x):
            if x.dtype == torch.bool:     # gathered as bytes on every backend
                return mesh.all_gather(x.to(torch.uint8))[:b].bool()
            return mesh.all_gather(x)[:b]

        return RegistrationResult(*(gather(x) for x in local))

    return eval_fn


def adam(lr: float) -> Optimizer:
    """``optax.adam(lr)``: no clipping, no weight decay, a constant
    learning rate."""
    return Optimizer(lr, transition_steps=1, decay_rate=1.0,
                     weight_decay=0.0, max_norm=float("inf"))


def make_sharded_train_step(cfg: Config, mesh: Mesh,
                            optimizer: Optimizer | None = None):
    """The data-parallel Desc-stage step: ``step(model, opt_state, batches,
    draws) -> (opt_state, metrics)``.

    ``batches`` and ``draws`` are this rank's samples (equally many on every
    rank): training batch dicts and their :class:`TrainDraws`. ``model`` is
    the descriptor net in training mode, built with ``bn_group=mesh``
    (``train_models(cfg, state_dicts, mesh.device, bn_group=mesh)``), the
    same weights on every rank. As the JAX step: each local sample's
    BatchNorm statistics are averaged with the same sample's on the other
    ranks, the loss is the mean over the local samples and then over the
    ranks, the gradients are averaged over the ranks, and the new running
    statistics are those of the first local sample, averaged over the
    ranks. The parameters and the running statistics are updated in place;
    the metrics (loss, desc_loss, desc_acc, eqv_loss, eqv_acc) are 0-d
    tensors averaged over the ranks. ``optimizer`` defaults to
    ``optax.adam(cfg.optim.lr("Desc"))``'s arithmetic.
    """
    optimizer = adam(cfg.optim.lr("Desc")) if optimizer is None else optimizer
    statics = TrainStatics.from_config(cfg)
    world = mesh.world_size

    def mean(t: torch.Tensor) -> torch.Tensor:
        return mesh.all_reduce(t) / world

    def step(model, opt_state, batches: Sequence[dict], draws: Sequence):
        if len(batches) != len(draws) or not batches:
            raise ValueError(f"{len(batches)} batches, {len(draws)} draws")
        for m in model.modules():
            if isinstance(m, ConvBNRelu) and m.use_bn and \
                    m.bn_group is not mesh:
                raise ValueError("build the model with bn_group=mesh: its "
                                 "BatchNorm statistics are shared over the "
                                 "ranks")
        params = dict(model.named_parameters())
        out = [desc_stage_loss(model, statics, b, d)
               for b, d in zip(batches, draws)]
        loss = torch.stack([o[0] for o in out]).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            flat = mean(torch.cat([g.reshape(-1) for g in grads]))
            grads = dict(zip(params, torch.split(
                flat, [g.numel() for g in grads])))
            grads = {k: g.view_as(params[k]) for k, g in grads.items()}
            current = {k: p.detach() for k, p in params.items()}
            updates, opt_state = optimizer.update(grads, opt_state, current)
            for k, p in params.items():
                p.copy_(current[k] + updates[k])
            buffers = dict(model.named_buffers())
            for k, v in out[0][1]["batch_stats"].items():
                buffers[k].copy_(mean(v))
            metrics = {name: mean(torch.stack([o[1][name] for o in out])
                                  .mean())
                       for name in ("desc_loss", "desc_acc", "eqv_loss",
                                    "eqv_acc")}
            metrics["loss"] = mean(loss.detach())
        return opt_state, metrics

    return step
