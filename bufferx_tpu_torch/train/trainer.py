"""Two-stage trainer (Desc, then Pose): the guarded optimizer step, the
train steps, checkpoints and the host loop.

Counterpart of :mod:`bufferx_tpu.train.trainer`:

- :class:`Optimizer` is the optax chain ``clip_by_global_norm(5.0) ->
  add_decayed_weights(wd) -> adam(exponential_decay(lr, staircase=True))``
  written out over explicit state tensors (:class:`AdamState`), so that a
  step can be taken back: ``torch.optim.Adam`` keeps its state inside and
  cannot roll it back;
- :func:`guarded_update` applies a step only if both the gradients and the
  updates are finite, and otherwise keeps the parameters, the Adam moments
  and the step count as they were. The choice is a ``torch.where`` on the
  device: no value is read back to the host inside a step;
- :func:`make_train_step`'s steps also keep the BatchNorm running
  statistics when the step or the new statistics are not finite;
- checkpoints are flax msgpack (:mod:`bufferx_tpu_torch.tools.weights`), so
  both packages read what either writes; :class:`Trainer` is the epoch loop
  with resume and a best loss that persists across runs.

The trainable model's parameters and running statistics are updated in
place; the optimizer state is passed in and returned.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Iterable, NamedTuple

import torch

from bufferx_tpu_torch.config import Config
from bufferx_tpu_torch.models.spinnet import MiniSpinNet
from bufferx_tpu_torch.pipeline.registration import (
    PipelineStatics,
    build_models,
)
from bufferx_tpu_torch.tools.weights import (
    DESC_MODULES,
    POSE_MODULES,
    msgpack_dumps,
    msgpack_restore,
    numpy_from_params,
    params_from_numpy,
    read_checkpoint,
    write_checkpoint,
)
from bufferx_tpu_torch.train.forward import (
    TrainStatics,
    desc_stage_loss,
    make_train_draws,
    pose_stage_loss,
)
from bufferx_tpu_torch.train.guard import CollapseGuard

__all__ = ["AdamState", "Optimizer", "make_optimizer", "guarded_update",
           "make_train_step", "train_models", "save_params", "load_params",
           "compose_staged_params", "save_train_state", "restore_train_state",
           "Trainer"]


class AdamState(NamedTuple):
    """The optimizer state: ``count`` is the number of steps applied (a 0-d
    int32 tensor; optax keeps it twice, in ``ScaleByAdamState`` and in
    ``ScaleByScheduleState``, and the two always agree); ``mu`` and ``nu``
    are Adam's moments, per parameter name."""
    count: torch.Tensor
    mu: dict
    nu: dict


class Optimizer:
    """Global-norm clipping, decoupled-into-the-gradient weight decay and
    Adam with a staircase exponential learning-rate decay, with optax's
    arithmetic in optax's order."""

    def __init__(self, lr: float, transition_steps: int, decay_rate: float,
                 weight_decay: float, max_norm: float = 5.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr = lr
        self.transition_steps = transition_steps
        self.decay_rate = decay_rate
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict) -> AdamState:
        dev = next(iter(params.values())).device
        return AdamState(
            torch.zeros((), dtype=torch.int32, device=dev),
            {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()},
        )

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """``exponential_decay(lr, transition_steps, decay_rate,
        staircase=True)`` at ``count``."""
        p = torch.floor(count.to(torch.float32) / self.transition_steps)
        decayed = self.lr * torch.pow(self.decay_rate, p)
        return torch.where(count <= 0, self.lr, decayed)

    def update(self, grads: dict, state: AdamState, params: dict):
        """(updates, new state) for ``grads`` at ``params``."""
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        trigger = g_norm < self.max_norm
        upd = {k: torch.where(trigger, g, (g / g_norm) * self.max_norm)
               for k, g in grads.items()}
        upd = {k: g + self.weight_decay * params[k] for k, g in upd.items()}
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in upd.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k]
              for k, g in upd.items()}
        count_inc = state.count + 1
        c = count_inc.to(torch.float32)
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)
        step = -self.learning_rate(state.count)
        upd = {k: step * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps))
               for k in upd}
        return upd, AdamState(count_inc, mu, nu)


def make_optimizer(cfg: Config, stage: str, steps_per_epoch: int) -> Optimizer:
    return Optimizer(
        lr=cfg.optim.lr(stage),
        transition_steps=max(
            cfg.optim.scheduler_interval(stage) * steps_per_epoch, 1),
        decay_rate=cfg.optim.lr_decay,
        weight_decay=cfg.optim.weight_decay,
    )


def _all_finite(tensors) -> torch.Tensor:
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def guarded_update(optimizer: Optimizer, grads: dict, opt_state: AdamState,
                   params: dict):
    """(new params, kept optimizer state, ok): the step is applied only if
    both the gradients and the updates are finite; otherwise the params and
    the whole optimizer state (moments and count) stay as they were. One
    non-finite gradient would poison Adam's moments, and a guard on the
    gradients alone would then write the next step's non-finite updates."""
    updates, new_opt = optimizer.update(grads, opt_state, params)
    ok = _all_finite(grads.values()) & _all_finite(updates.values())
    new_params = {k: torch.where(ok, p + updates[k], p)
                  for k, p in params.items()}
    kept = AdamState(
        torch.where(ok, new_opt.count, opt_state.count),
        {k: torch.where(ok, v, opt_state.mu[k]) for k, v in new_opt.mu.items()},
        {k: torch.where(ok, v, opt_state.nu[k]) for k, v in new_opt.nu.items()},
    )
    return new_params, kept, ok


def train_models(cfg: Config, state_dicts: dict, device="cuda",
                 bn_group=None):
    """(MiniSpinNet, CostVolume) with the given weights in float32 with the
    cuDNN backbone (the fused stack is serving-only) and in training mode,
    for :func:`make_train_step`; with ``bn_group`` (a ``Mesh``) their
    BatchNorm statistics are shared over its ranks, for
    :func:`~bufferx_tpu_torch.parallel.sharded.make_sharded_train_step`."""
    statics = dataclasses.replace(PipelineStatics.from_config(cfg),
                                  use_bf16=False, fused_conv=False)
    desc, pose = build_models(statics, state_dicts, device, bn_group)
    return desc.train(), pose.train()


def _stats_buffers(model: torch.nn.Module) -> dict:
    return {k: b for k, b in model.named_buffers()
            if k.endswith((".bn_mean", ".bn_var"))}


def make_train_step(cfg: Config, stage: str, optimizer: Optimizer) -> Callable:
    """The train step of ``stage``: ``step(model, opt_state, batch, draws)``
    for "Desc", ``step(model, opt_state, frozen, batch, draws)`` for "Pose"
    (``frozen``: the trained descriptor net, in training mode). It updates
    ``model``'s parameters and running statistics in place and returns
    (new opt_state, metrics), the metrics 0-d tensors on the device."""
    if stage not in ("Desc", "Pose"):
        raise ValueError(stage)
    statics = TrainStatics.from_config(cfg)

    def apply(model, opt_state, loss, aux):
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            new_params, new_opt, ok = guarded_update(
                optimizer, dict(zip(params, grads)), opt_state,
                {k: p.detach() for k, p in params.items()})
            for k, p in params.items():
                p.copy_(new_params[k])
            new_stats = aux.pop("batch_stats")
            stats_ok = ok & _all_finite(new_stats.values())
            for k, b in _stats_buffers(model).items():
                b.copy_(torch.where(stats_ok, new_stats[k], b))
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["loss"] = loss.detach()
        metrics["grads_finite"] = ok
        return new_opt, metrics

    def step_desc(model, opt_state, batch, draws):
        loss, aux = desc_stage_loss(model, statics, batch, draws)
        return apply(model, opt_state, loss, aux)

    def step_pose(model, opt_state, frozen, batch, draws):
        loss, aux = pose_stage_loss(model, frozen, statics, batch, draws)
        return apply(model, opt_state, loss, aux)

    return step_desc if stage == "Desc" else step_pose


def _modules_of(model) -> dict:
    return DESC_MODULES if isinstance(model, MiniSpinNet) else POSE_MODULES


def save_params(path: str, model: torch.nn.Module) -> str:
    """The model's weights as a flax ``{params, batch_stats}`` msgpack."""
    return write_checkpoint(path, model.state_dict(), _modules_of(model))


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a flax msgpack of either package into ``model`` (strict)."""
    model.load_state_dict(read_checkpoint(path, _modules_of(model)),
                          strict=True)
    return model


def compose_staged_params(desc_path: str, pose_path: str) -> dict:
    """Per-stage checkpoints -> {"desc": state_dict, "pose": state_dict}
    (the staged merge of the reference's test script)."""
    return {"desc": read_checkpoint(desc_path, DESC_MODULES),
            "pose": read_checkpoint(pose_path, POSE_MODULES)}


def save_train_state(path: str, model: torch.nn.Module, opt_state: AdamState,
                     epoch: int, best_loss: float) -> str:
    """Full training state (weights, optimizer state, progress) for a
    restart, written atomically: msgpack of ``{variables, opt_state: {count,
    mu, nu}, epoch, best_loss}`` (moments keyed by parameter name)."""
    def host(d):
        return {k: v.detach().cpu().numpy() for k, v in d.items()}

    payload = {
        "variables": numpy_from_params(model.state_dict(), _modules_of(model)),
        "opt_state": {"count": opt_state.count.cpu().numpy()[()],
                      "mu": host(opt_state.mu), "nu": host(opt_state.nu)},
        "epoch": int(epoch),
        "best_loss": float(best_loss),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_dumps(payload))
    os.replace(tmp, path)     # a crash mid-write never corrupts
    return path


def restore_train_state(path: str, model: torch.nn.Module):
    """Inverse of :func:`save_train_state`: loads the weights into ``model``
    and returns (opt_state on the model's device, epoch, best_loss)."""
    with open(path, "rb") as f:
        got = msgpack_restore(f.read())
    model.load_state_dict(params_from_numpy(got["variables"],
                                            _modules_of(model)), strict=True)
    dev = next(model.parameters()).device
    opt = got["opt_state"]

    def dev_dict(d):
        return {k: torch.from_numpy(v.copy()).to(dev) for k, v in d.items()}

    state = AdamState(torch.tensor(int(opt["count"]), dtype=torch.int32,
                                   device=dev),
                      dev_dict(opt["mu"]), dev_dict(opt["nu"]))
    return state, int(got["epoch"]), float(got["best_loss"])


class Trainer:
    """Host loop: epochs over a batch iterator, the best snapshot by
    validation loss (or the epoch's training loss without validation
    batches).

    ``train_batches()`` yields device batches (see
    :mod:`bufferx_tpu_torch.data.training`). Draws come from a generator on
    the model's device seeded with ``cfg.data.manual_seed``. Metrics are
    summed on the device and read every 200 steps and at the epoch's end.
    The full training state is written atomically every epoch
    (``state_latest.msgpack``); :meth:`resume` continues from it.
    """

    log_every = 200

    def __init__(self, cfg: Config, stage: str, model: torch.nn.Module,
                 frozen: torch.nn.Module | None,
                 train_batches: Callable[[], Iterable[dict]],
                 val_batches: Callable[[], Iterable[dict]] | None = None,
                 steps_per_epoch: int = 100,
                 snapshot_dir: str = "snapshot/run", log=print):
        self.cfg = cfg
        self.stage = stage
        self.model = model
        self.frozen = frozen
        self.train_batches = train_batches
        self.val_batches = val_batches
        self.snapshot_dir = snapshot_dir
        self.log = log
        self.statics = TrainStatics.from_config(cfg)
        self.optimizer = make_optimizer(cfg, stage, steps_per_epoch)
        self.opt_state = self.optimizer.init(dict(model.named_parameters()))
        self.step_fn = make_train_step(cfg, stage, self.optimizer)
        dev = next(model.parameters()).device
        self.generator = torch.Generator(dev).manual_seed(cfg.data.manual_seed)
        # the best loss persists across runs: a second fine-tune pass starts
        # against the existing best checkpoint's loss, so a worse run never
        # overwrites best.msgpack
        self.best_loss = self._load_best_meta()
        self.start_epoch = 0

    def _path(self, name: str) -> str:
        return os.path.join(self.snapshot_dir, self.stage, name)

    def _load_best_meta(self) -> float:
        if os.path.exists(self._path("best_meta.json")) and \
                os.path.exists(self._path("best.msgpack")):
            try:
                with open(self._path("best_meta.json")) as f:
                    return float(json.load(f)["best_loss"])
            except (OSError, KeyError, ValueError):
                pass
        return float("inf")

    def _write_best_meta(self) -> None:
        os.makedirs(os.path.dirname(self._path("best_meta.json")),
                    exist_ok=True)
        with open(self._path("best_meta.json"), "w") as f:
            json.dump({"best_loss": self.best_loss, "stage": self.stage}, f)

    def resume(self, path: str | None = None) -> bool:
        """Restore from a full training state; True if resumed."""
        path = path or self._path("state_latest.msgpack")
        if not os.path.exists(path):
            return False
        self.opt_state, epoch, self.best_loss = restore_train_state(
            path, self.model)
        self.start_epoch = epoch + 1
        self.log(f"resumed {self.stage} from {path} at epoch "
                 f"{self.start_epoch}")
        return True

    def _draws(self, batch: dict):
        return make_train_draws(self.statics, batch["src_fds"].shape[0],
                                self.generator, batch["src_fds"].device)

    def _step(self, batch: dict) -> dict:
        draws = self._draws(batch)
        if self.stage == "Desc":
            self.opt_state, m = self.step_fn(self.model, self.opt_state,
                                             batch, draws)
        else:
            self.opt_state, m = self.step_fn(self.model, self.opt_state,
                                             self.frozen, batch, draws)
        return m

    @staticmethod
    def _read(sums: dict, n: int) -> dict:
        return {k: float(v) / max(n, 1) for k, v in sums.items()}

    def train(self, epochs: int | None = None) -> torch.nn.Module:
        epochs = epochs or self.cfg.train.epoch
        watch = "desc_loss" if self.stage == "Desc" else "match_loss"
        guard = CollapseGuard(patience=2) if self.stage == "Desc" else None
        for epoch in range(self.start_epoch, epochs):
            sums: dict = {}
            n = 0
            t0 = time.perf_counter()
            for i, batch in enumerate(self.train_batches()):
                m = self._step(batch)
                for k, v in m.items():
                    v = v.to(torch.float32)
                    sums[k] = sums[k] + v if k in sums else v
                n += 1
                if (i + 1) % self.log_every == 0:
                    avg = self._read(sums, n)
                    self.log(f"epoch {epoch + 1} [{i + 1}] "
                             + " ".join(f"{k}:{v:.4f}" for k, v in avg.items())
                             + f" step:{(time.perf_counter() - t0) / n:.2f}s")
            avg = self._read(sums, n)
            val_loss = self.evaluate() if self.val_batches else avg[watch]
            self.log(f"epoch {epoch + 1} done: "
                     + " ".join(f"{k}:{v:.4f}" for k, v in avg.items())
                     + f" val_{watch}:{val_loss:.4f}")
            self._emit_scalars(epoch, avg, val_loss, watch)
            save_params(self._path(f"{epoch}.msgpack"), self.model)
            save_train_state(self._path("state_latest.msgpack"), self.model,
                             self.opt_state, epoch, self.best_loss)
            if val_loss < self.best_loss:
                self.best_loss = val_loss
                save_params(self._path("best.msgpack"), self.model)
                self._write_best_meta()
            if guard is not None and guard.update(epoch, avg,
                                                  self.model.state_dict()):
                self.log(f"[{self.stage}] COLLAPSE at epoch {epoch + 1} "
                         "(contrastive saddle / non-finite streak): restoring "
                         "the last good state and stopping this stage")
                if os.path.exists(self._path("best.msgpack")):
                    load_params(self._path("best.msgpack"), self.model)
                else:
                    self.model.load_state_dict(
                        guard.restore(self.model.state_dict()))
                break
        return self.model

    def _emit_scalars(self, epoch: int, avg: dict, val_loss: float,
                      watch: str) -> None:
        """Append one JSON line a epoch to ``<stage>/scalars.jsonl``."""
        path = self._path("scalars.jsonl")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        rec = dict(epoch=epoch, stage=self.stage,
                   **{k: round(v, 6) for k, v in avg.items()})
        rec[f"val_{watch}"] = round(float(val_loss), 6)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def evaluate(self) -> float:
        """Mean stage loss over the validation batches (training-mode
        BatchNorm, no update)."""
        total, n = None, 0
        with torch.no_grad():
            for batch in self.val_batches():
                draws = self._draws(batch)
                if self.stage == "Desc":
                    _, aux = desc_stage_loss(self.model, self.statics, batch,
                                             draws)
                    v = aux["desc_loss"]
                else:
                    _, aux = pose_stage_loss(self.model, self.frozen,
                                             self.statics, batch, draws)
                    v = aux["match_loss"]
                total = v if total is None else total + v
                n += 1
        return float(total) / max(n, 1) if total is not None else 0.0
