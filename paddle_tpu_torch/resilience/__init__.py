"""Fault-tolerant runtime (the port's counterpart of paddle_tpu/resilience).

  health      per-rank heartbeat files that the launcher's hang detector
              and /healthz read (PADDLE_TPU_HEARTBEAT_DIR)

The reference's `retry`, `preemption`, `watchdog`, `anomaly` and `chaos`
are still to be ported.
"""
from __future__ import annotations

from . import health  # noqa: F401

__all__ = ["health"]
