"""Step watchdog: bound a dispatch that may hang, dumping diagnostics (the
port's copy of paddle_tpu/resilience/watchdog.py).

A wedged device can block a replay, or the synchronize after it, forever
inside native code, where no Python signal is delivered. An
in-process watchdog cannot cancel the stuck call, but it can make the hang
observable and actionable: after `timeout_s` it dumps every thread's
stack (faulthandler) and the caller's context to stderr and to an
optional file, then either keeps waiting (action="warn") or exits hard
with a distinctive code so that a supervisor restarts the process
(action="abort", exit code 124, as `timeout(1)` gives).
"""
from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time

__all__ = ["ABORT_EXIT_CODE", "ENV_FILE", "StepWatchdog"]

ABORT_EXIT_CODE = 124
ENV_FILE = "PADDLE_TPU_WATCHDOG_FILE"


class StepWatchdog:
    """Context manager: dump diagnostics if the body outlives `timeout_s`.

        with StepWatchdog(30.0, context="compiled train step 812"):
            graph.replay(); torch.cuda.synchronize()

    `action`: "warn" (default) dumps once and lets the body keep waiting;
    "abort" dumps then os._exit(124). The dump also goes to the file
    PADDLE_TPU_WATCHDOG_FILE names, when it is set, so the diagnostics
    survive a supervisor's truncation of stderr. A firing also counts
    `pt_watchdog_fires_total`, writes a `watchdog` journal event and dumps
    a crash bundle of the flight ring."""

    def __init__(self, timeout_s: float, context: str = "",
                 action: str = "warn"):
        if action not in ("warn", "abort"):
            raise ValueError("action must be 'warn' or 'abort', got %r"
                             % (action,))
        self.timeout_s = float(timeout_s)
        self.context = context
        self.action = action
        self.diag_path = os.environ.get(ENV_FILE)
        self.fired = False
        self._timer = None
        self._t0 = None

    def _dump(self, stream):
        stream.write(
            "\n=== paddle_tpu StepWatchdog: %r exceeded %.1fs "
            "(started %.1fs ago, pid %d, action=%s) ===\n"
            % (self.context or "step", self.timeout_s,
               time.monotonic() - self._t0, os.getpid(), self.action))
        stream.flush()
        faulthandler.dump_traceback(file=stream, all_threads=True)
        stream.write("=== end watchdog dump ===\n")
        stream.flush()

    def _fire(self):
        self.fired = True
        try:
            self._dump(sys.stderr)
            if self.diag_path:
                with open(self.diag_path, "a") as f:
                    self._dump(f)
        except Exception:
            pass  # diagnostics must never mask the original condition
        try:
            from ..observability import flight, journal, metrics
            metrics.counter("pt_watchdog_fires_total",
                            "StepWatchdog timeouts").inc()
            journal.emit("watchdog", context=self.context,
                         timeout_s=self.timeout_s, action=self.action)
            # with action="abort" this process is gone two lines below:
            # bundle the flight ring now
            flight.dump_crash_bundle("watchdog", context=self.context,
                                     timeout_s=self.timeout_s,
                                     action=self.action)
        except Exception:
            pass
        if self.action == "abort":
            os._exit(ABORT_EXIT_CODE)

    def __enter__(self):
        self._t0 = time.monotonic()
        if self.timeout_s > 0:
            self._timer = threading.Timer(self.timeout_s, self._fire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        return False
