"""Loss-anomaly guard: account for skipped non-finite steps, bound them
(the port's copy of paddle_tpu/resilience/anomaly.py).

The captured train step (jit/engine.py, FLAGS_skip_nonfinite_steps) and
the eager path both SKIP an update whose loss or gradients are not
finite, the contract of the reference's dynamic loss scaler
(found_inf: zero the update, shrink the scale). `AnomalyGuard` is the
host-side accountant: it counts skips, coordinates the amp GradScaler (a
skipped step counts as found_inf, so the scale still backs off), and
raises after `max_consecutive` consecutive skips.

The port's GradScaler keeps found_inf as a 0-d bool on the device until
it reads it (amp/__init__.py); the guard overwrites it with True and
calls `update()`, which shrinks the scale by the scaler's own state
machine, as the reference's guard does through `_found_inf`.
"""
from __future__ import annotations

import math
from typing import Optional

__all__ = ["NonFiniteLossError", "AnomalyGuard"]


class NonFiniteLossError(RuntimeError):
    """Too many consecutive non-finite training steps."""


class AnomalyGuard:
    """Observe per-step (loss, skipped) pairs; fail after a skip streak.

        guard = AnomalyGuard(max_consecutive=25, scaler=scaler)
        ...
        skipped = guard.observe(loss_value, skipped=step_was_skipped)
    """

    def __init__(self, max_consecutive: int = 25, scaler=None,
                 on_skip=None):
        self.max_consecutive = int(max_consecutive)
        self.scaler = scaler
        self.on_skip = on_skip
        self.consecutive = 0
        self.total_skipped = 0
        self.total_steps = 0

    @staticmethod
    def _finite(loss) -> bool:
        try:
            return math.isfinite(float(loss))
        except (TypeError, ValueError, RuntimeError):
            return False

    def observe(self, loss, skipped: Optional[bool] = None) -> bool:
        """Record one step. `skipped` True means the update was already
        suppressed (the captured step's guard); None means decide from the
        loss value alone. Returns whether the step counted as skipped."""
        self.total_steps += 1
        if skipped is None:
            skipped = not self._finite(loss)
        if not skipped:
            self.consecutive = 0
            return False
        self.consecutive += 1
        self.total_skipped += 1
        try:
            # the guard owns this counter (not the train step), so eager
            # and captured skips land in ONE series, never counted twice
            from ..observability import journal, metrics
            metrics.counter("pt_nonfinite_steps_total",
                            "Train steps skipped for non-finite "
                            "loss/grads").inc()
            journal.emit("nonfinite_skip",
                         loss=None if loss is None else str(loss),
                         consecutive=self.consecutive,
                         total=self.total_skipped)
        except Exception:
            pass
        if self.scaler is not None and getattr(self.scaler, "_enable", False):
            # a skipped step IS a found_inf event for the loss scaler: let
            # its decr_every_n/incr_every_n state machine shrink the scale
            self.scaler._found_inf = True
            self.scaler.update()
        if self.on_skip is not None:
            self.on_skip(loss, self.consecutive)
        if self.consecutive >= self.max_consecutive:
            raise NonFiniteLossError(
                "training produced non-finite loss/grads for %d consecutive "
                "steps (%d/%d total skipped) — not a transient spike; "
                "check data, learning rate, and FLAGS_check_nan_inf "
                "per-op localization" % (self.consecutive,
                                         self.total_skipped,
                                         self.total_steps))
        return True
