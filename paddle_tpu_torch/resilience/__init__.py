"""Fault-tolerant runtime (the port's counterpart of paddle_tpu/resilience).

  health      per-rank heartbeat files that the launcher's hang detector
              and /healthz read (PADDLE_TPU_HEARTBEAT_DIR)
  watchdog    StepWatchdog: a train step that outlives its bound dumps
              every thread's stack (FLAGS_step_watchdog_s)
  chaos       deterministic fault injection for the drills
              (PADDLE_TPU_CHAOS: nan_at_step, hang_at_step, oom)

The reference's `retry`, `preemption` and `anomaly` are still to be
ported.
"""
from __future__ import annotations

from . import chaos, health, watchdog  # noqa: F401
from .watchdog import StepWatchdog  # noqa: F401

__all__ = ["chaos", "health", "watchdog", "StepWatchdog"]
