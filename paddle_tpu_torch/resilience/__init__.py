"""Fault-tolerant runtime (the port's counterpart of paddle_tpu/resilience).

  retry       RetryPolicy / with_deadline: bounded backoff and a hard
              deadline
  preemption  PreemptionGuard: SIGTERM/SIGINT -> checkpoint -> clean exit
  health      per-rank heartbeat files that the launcher's hang detector
              and /healthz read (PADDLE_TPU_HEARTBEAT_DIR)
  watchdog    StepWatchdog: a train step that outlives its bound dumps
              every thread's stack (FLAGS_step_watchdog_s)
  chaos       deterministic fault injection for the drills
              (PADDLE_TPU_CHAOS: nan_at_step, hang_at_step, oom,
              sigterm_at_step, torn_write, bitflip_ckpt)
  anomaly     AnomalyGuard: counts skipped non-finite steps, shrinks the
              GradScaler's scale, raises NonFiniteLossError on a streak
"""
from __future__ import annotations

from . import chaos, health, watchdog  # noqa: F401
from .anomaly import AnomalyGuard, NonFiniteLossError  # noqa: F401
from .preemption import PreemptionGuard, active_guard  # noqa: F401
from .retry import (DeadlineExceeded, RetryExhausted, RetryPolicy,  # noqa: F401
                    with_deadline)
from .watchdog import StepWatchdog  # noqa: F401

__all__ = ["chaos", "health", "watchdog", "AnomalyGuard",
           "NonFiniteLossError", "StepWatchdog", "PreemptionGuard",
           "active_guard", "DeadlineExceeded", "RetryExhausted",
           "RetryPolicy", "with_deadline"]
