"""Preemption-safe shutdown: catch SIGTERM/SIGINT, finish the step, save
(the port's copy of paddle_tpu/resilience/preemption.py).

A preempted job gets a SIGTERM and a short grace window. Dying mid-step
loses the work since the last checkpoint, and ignoring the signal gets the
job SIGKILLed. `PreemptionGuard` turns the signal into a polled flag: the
training loop runs on to its next safe point (an epoch or batch boundary),
writes an atomic checkpoint and exits cleanly, and the relaunched job
resumes (incubate/checkpoint.py TrainEpochRange).

Inside the handler the guard counts `pt_preemptions_total`, journals a
`preemption` event, gives an in-flight async checkpoint save its grace
window (`paddle_tpu_torch.checkpoint.engine.flush_on_preemption`) and
tells the flight recorder (`paddle_tpu_torch.observability.flight
.on_preemption`). Both modules are found in `sys.modules` only: a signal
handler imports nothing, so a process that never loaded them flushes
nothing.

Standard library only. Signal handlers install only from the main thread
(a Python rule); elsewhere the guard is a flag that `trigger()` sets.
"""
from __future__ import annotations

import signal
import sys
import threading
import time
from typing import Callable, List, Optional

__all__ = ["PreemptionGuard", "active_guard"]

# where the handler looks for the checkpoint engine and the flight
# recorder, without importing them
ENGINE_MODULE = "paddle_tpu_torch.checkpoint.engine"
FLIGHT_MODULE = "paddle_tpu_torch.observability.flight"


class PreemptionGuard:
    """Deferred SIGTERM/SIGINT: record, don't die.

        with PreemptionGuard() as guard:
            for step, batch in enumerate(loader):
                train_step(batch)
                if guard.triggered:
                    save_checkpoint(...)
                    break

    While installed, the first signal sets `.triggered` (and runs any
    `add_callback` hooks, signal-async-safe work only); a SECOND signal of
    the same kind re-raises the previous handler's behavior — an operator
    double-Ctrl-C still kills a stuck loop. Nesting installs is a no-op
    (the outermost guard owns the handlers)."""

    _installed: Optional["PreemptionGuard"] = None

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self.triggered = False
        self.signum: Optional[int] = None
        self.trigger_time: Optional[float] = None
        self._callbacks: List[Callable[[int], None]] = []
        self._prev = {}
        self._owner = False

    def add_callback(self, fn: Callable[[int], None]):
        self._callbacks.append(fn)
        return self

    def trigger(self, signum: int = signal.SIGTERM):
        """Programmatic trigger (tests, and the flag-only mode off the main
        thread); a second signal still goes through the real handler."""
        self._handle(signum, None)

    def _handle(self, signum, frame):
        if self.triggered:
            # second signal: restore + re-deliver so escalation works
            prev = self._prev.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            if callable(prev):
                prev(signum, frame)
            else:
                signal.raise_signal(signum)
            return
        self.triggered = True
        self.signum = signum
        self.trigger_time = time.monotonic()
        try:
            # the journal locks with an RLock, so a handler that interrupts
            # a frame holding it cannot deadlock
            from ..observability import journal, metrics
            metrics.counter("pt_preemptions_total",
                            "Preemption signals caught").inc()
            journal.emit("preemption", signum=int(signum))
        except Exception:
            pass  # telemetry must not lose the preemption flag
        try:
            # grace-window flush: an async save captured before the signal
            # still commits (only if the engine is already loaded)
            eng = sys.modules.get(ENGINE_MODULE)
            if eng is not None:
                eng.flush_on_preemption()
        except Exception:
            pass  # a failed flush must not lose the preemption flag
        try:
            # a bundle only when PADDLE_TPU_FLIGHT_DUMP_ON_TERM opts in (a
            # preemption is an orderly exit, not a crash)
            fl = sys.modules.get(FLIGHT_MODULE)
            if fl is not None:
                fl.on_preemption(signum)
        except Exception:
            pass
        for fn in self._callbacks:
            try:
                fn(signum)
            except Exception:
                pass  # a broken hook must not lose the preemption flag

    def install(self):
        if PreemptionGuard._installed is not None:
            return self  # outermost guard owns the handlers
        if threading.current_thread() is not threading.main_thread():
            return self  # flag-only mode off the main thread
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handle)
        self._owner = True
        PreemptionGuard._installed = self
        return self

    def uninstall(self):
        if not self._owner:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._owner = False
        if PreemptionGuard._installed is self:
            PreemptionGuard._installed = None

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


def active_guard() -> Optional[PreemptionGuard]:
    """The currently-installed guard, if any (loops deep in the stack can
    poll preemption without plumbing the object through)."""
    return PreemptionGuard._installed
