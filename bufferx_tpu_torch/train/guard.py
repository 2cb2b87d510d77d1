"""Training-collapse detection and last-good-state rescue.

Counterpart of :class:`bufferx_tpu.train.guard.CollapseGuard`. The
contrastive Desc stage has a saddle at ``desc_loss == neg_margin -
pos_margin`` (1.30 with the default margins) where ``desc_acc`` pins to its
floor; a fine-tune pass can fall into it and overwrite a good checkpoint.
Callers feed the guard the scalar metrics they already read (at the logging
interval) and the model's state dict; it keeps a host copy of the last
healthy state and reports a collapse once the saddle signature (or
rejected steps) has been seen ``patience`` times in a row.
"""

from __future__ import annotations

from typing import Any

__all__ = ["CollapseGuard"]


def _to_host(state: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


class CollapseGuard:
    """Saddle/divergence detector with last-good-state snapshots.

    Collapse signature (any of, ``patience`` consecutive observations):

    - ``desc_loss`` within ``tol`` of the saddle value while ``desc_acc``
      is under ``acc_floor``;
    - ``desc_acc`` under ``acc_floor`` after the run has exceeded
      ``2 * acc_floor`` once (a crash; off with ``detect_crash=False``,
      which a curriculum needs: its phase changes drop ``desc_acc``
      legitimately);
    - ``grads_finite`` false (the guarded update rejected the step).

    ``update`` returns True when training should stop. While healthy it
    copies the state dict to the host, so the caller can restore the most
    recent good state.
    """

    def __init__(self, saddle_value: float = 1.4 - 0.1, tol: float = 0.02,
                 acc_floor: float = 0.05, patience: int = 6,
                 detect_crash: bool = True):
        self.saddle_value = saddle_value
        self.tol = tol
        self.acc_floor = acc_floor
        self.patience = patience
        self.detect_crash = detect_crash
        self.bad_streak = 0
        self.seen_healthy_acc = False
        self.last_good_variables: Any = None
        self.last_good_step: int = -1
        self.collapsed = False

    def _is_bad(self, metrics: dict) -> bool:
        if float(metrics.get("grads_finite", 1.0)) < 0.5:
            return True
        dl = metrics.get("desc_loss")
        da = metrics.get("desc_acc")
        if da is not None and float(da) >= 2.0 * self.acc_floor:
            self.seen_healthy_acc = True
        if dl is not None and da is not None:
            at_saddle = (abs(float(dl) - self.saddle_value) <= self.tol
                         and float(da) < self.acc_floor)
            crashed = (self.detect_crash and self.seen_healthy_acc
                       and float(da) < self.acc_floor)
            return at_saddle or crashed
        return False

    def update(self, step: int, metrics: dict, variables: dict) -> bool:
        """Observe one metrics emission (host numbers) and the current state
        dict; returns True on collapse."""
        if self.collapsed:
            return True
        if self._is_bad(metrics):
            self.bad_streak += 1
        else:
            self.bad_streak = 0
            self.last_good_variables = _to_host(variables)
            self.last_good_step = step
        if self.bad_streak >= self.patience:
            self.collapsed = True
        return self.collapsed

    def restore(self, fallback: Any) -> Any:
        """The last healthy state dict (host tensors), or ``fallback`` if
        the run never produced one."""
        good = self.last_good_variables
        return good if good is not None else fallback
