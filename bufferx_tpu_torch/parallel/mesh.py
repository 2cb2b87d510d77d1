"""Ranks and their process group: the port's counterpart of ``make_mesh``.

The JAX package lays a named device mesh over the chips of one program
(``shard_map`` over "dp": pairs; "fp": pose-graph factors). Here every
rank is a process with one device, and a :class:`Mesh` holds the process
group, this rank, the world size, the device and the axis name. The
backend follows the device: NCCL for a card, gloo only when the caller asks
for the CPU. It never switches backend or device on its own, and it raises
when more ranks are asked for than exist.

:func:`spawn` starts ``world_size`` ranks on this host with
``torch.multiprocessing`` (one card each, or gloo ranks on the CPU); for
several hosts, start the ranks with ``torchrun`` and call
:func:`make_mesh` in each, which reads the usual environment variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist

from bufferx_tpu_torch.device import resolve_device

__all__ = ["Mesh", "make_mesh", "spawn"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the ranks. ``group`` is None only for a single
    process that started no process group: its collectives return their
    input."""
    group: Any
    rank: int
    world_size: int
    device: torch.device
    axis_name: str = "dp"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor; no gradient)."""
        if self.group is None:
            return t
        out = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out

    def mean_with_grad(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks, differentiable: its gradient is
        the mean of the ranks' gradients (the transpose of ``lax.pmean``)."""
        if self.group is None:
            return t
        return _SumOverRanks.apply(t, self.group) / self.world_size

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` [n, ...] (equal shapes) concatenated in rank
        order: [world_size * n, ...]."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (SUM) whose backward is the all-reduce (SUM) of the
    incoming gradient: every rank's output depends on every rank's input."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def _card_of(rank: int) -> torch.device:
    count = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", rank % max(count, 1)))
    if local >= count:
        raise ValueError(f"rank {rank} (local rank {local}) has no card: "
                         f"{count} on this host")
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def make_mesh(n_ranks: int | None = None, axis_name: str = "dp",
              device="cuda", init_method: str | None = None,
              rank: int | None = None,
              world_size: int | None = None) -> Mesh:
    """A :class:`Mesh` over all ranks of the process group.

    Without a process group yet, one is started: from ``init_method`` (for
    example ``tcp://localhost:<port>``) with ``rank`` and ``world_size``,
    or from the environment variables ``torchrun`` sets. A process with
    neither is a world of one with no group. The backend is NCCL for
    ``device="cuda"`` (one card a rank) and gloo for ``device="cpu"``; an
    existing group with the other backend raises. ``n_ranks``, when given,
    must be the world size: more ranks than exist, or fewer (start that
    many instead), raise ``ValueError``.
    """
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if init_method is None and "WORLD_SIZE" not in os.environ:
            if n_ranks not in (None, 1):
                raise ValueError(f"requested {n_ranks} ranks, have 1 (no "
                                 "process group)")
            return Mesh(None, 0, 1, dev, axis_name)
        me = rank if rank is not None else int(os.environ.get("RANK", 0))
        if dev.type == "cuda":
            dev = _card_of(me)
        kw = {} if rank is None else dict(rank=rank, world_size=world_size)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                **kw)
    elif dev.type == "cuda":
        dev = _card_of(dist.get_rank())
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}; a "
                         f"{dev.type} mesh needs {backend}")
    world = dist.get_world_size()
    if n_ranks not in (None, world):
        raise ValueError(f"requested {n_ranks} ranks, have {world}")
    return Mesh(dist.group.WORLD, dist.get_rank(), world, dev, axis_name)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_rank(rank: int, fn: Callable, world_size: int, device: str,
              init_method: str, out_dir: str, args: tuple) -> None:
    mesh = make_mesh(device=device, init_method=init_method, rank=rank,
                     world_size=world_size)
    try:
        out = fn(mesh, *args)
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, device="cuda",
          args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` new ranks of this host and
    return their results in rank order. The ranks form one group over
    ``tcp://localhost`` on a free port: NCCL with one card a rank for
    ``device="cuda"`` (raises when the host has fewer cards), gloo for
    ``device="cpu"``. ``fn`` is pickled by name (a module-level function);
    its result is written with ``torch.save`` and read back on the CPU.
    A failing rank raises here, and the others are stopped. Each rank
    imports the caller's ``__main__`` anew, so a calling script keeps its
    work under ``if __name__ == "__main__":``."""
    dev = resolve_device(device)
    if world_size < 1:
        raise ValueError(f"world_size {world_size}")
    if dev.type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} ranks need as many cards, have "
                         f"{torch.cuda.device_count()}")
    init_method = f"tcp://localhost:{_free_port()}"
    with tempfile.TemporaryDirectory(prefix="bufferx_ranks_") as out_dir:
        torch.multiprocessing.start_processes(
            _run_rank, args=(fn, world_size, dev.type, init_method, out_dir,
                             tuple(args)),
            nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]
