"""Step/program telemetry: retrace accounting + latency recording (the
port's counterpart of paddle_tpu/observability/tracing.py).

`StepTelemetry` answers, for one dispatch engine, how many programs were
built, how long the builds took and what the steady-state step time is
once every program is built. Here a "retrace" is a program build of
`jit/cuda_graph.StepPrograms` (on CUDA an eager run plus a graph
capture), where the reference counts an XLA trace and compile:

  * the first dispatch of a signature increments
    `pt_jit_retraces_total{engine=...}` and banks its wall time into
    `pt_jit_compile_seconds_total{engine=...}`;
  * later dispatches (replays) record in-call wall time into
    `pt_step_latency_seconds{engine=...}` and entry-to-entry gaps into
    `pt_step_interval_seconds{engine=...}`, whose mean is the
    steady-state step time of a saturated loop.

Each finished dispatch also rings the flight recorder (with a rate-limited
device-memory sample) and ticks the heartbeat. Telemetry defaults ON
(a set lookup and two clock reads a step); `PADDLE_TPU_TELEMETRY=0` or
`enable(False)` turns the spans into no-ops, and the serving spans
(observability/spans.py) read the same switch.

Left out against the reference: the persistent compilation-cache probe
(`set_compile_cache_probe`; the port has no persistent program cache
yet), and the profiler ranges the reference opens around each dispatch.
"""
from __future__ import annotations

import os
import time
from typing import Optional

from . import flight, journal, metrics

__all__ = ["enabled", "enable", "StepTelemetry", "record_sync",
           "record_feed_stall", "SYNC_SECONDS", "TRAIN_STEPS", "FEED_STALL"]

_enabled = os.environ.get("PADDLE_TPU_TELEMETRY", "1") != "0"


def enabled() -> bool:
    return _enabled


def enable(on: bool = True):
    """Flip telemetry globally (tests and the overhead measurement)."""
    global _enabled
    _enabled = bool(on)


RETRACES = metrics.counter(
    "pt_jit_retraces_total",
    "Executable-cache misses (first compile included) per engine",
    labelnames=("engine",))
COMPILE_SECONDS = metrics.counter(
    "pt_jit_compile_seconds_total",
    "Wall time spent tracing+compiling per engine", labelnames=("engine",))
STEP_LATENCY = metrics.histogram(
    "pt_step_latency_seconds",
    "In-call wall time of cache-hit dispatches (async: excludes device "
    "time still in flight)", labelnames=("engine",))
STEP_INTERVAL = metrics.histogram(
    "pt_step_interval_seconds",
    "Entry-to-entry gap between consecutive cache-hit dispatches; mean "
    "== steady-state step time of a saturated loop",
    labelnames=("engine",))
SYNC_SECONDS = metrics.counter(
    "pt_device_sync_seconds_total",
    "Wall time blocked on device sync (host reads of device values)")
TRAIN_STEPS = metrics.counter(
    "pt_train_steps_total", "Train steps dispatched")
FEED_STALL = metrics.histogram(
    "pt_feed_stall_ms",
    "Per-batch milliseconds the consumer waited on the input feed; mean "
    "~0 when prefetch keeps the device fed, ~decode time when starved")


class _Span:
    """One dispatch measurement; hand back via StepTelemetry.step()."""

    __slots__ = ("tel", "miss", "t0")

    def __init__(self, tel: "StepTelemetry", miss: bool):
        self.tel = tel
        self.miss = miss

    def __enter__(self):
        if self.tel is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.tel is not None and exc_type is None:
            self.tel._finish(self, time.perf_counter() - self.t0)
        return False


_NULL_SPAN = _Span(None, False)


class StepTelemetry:
    """Retrace + latency accounting for one dispatch engine.

        tel = StepTelemetry("serve_decode")
        with tel.step(signature):      # signature: hashable program key
            ...build or replay the program...
    """

    def __init__(self, engine: str):
        self.engine = engine
        self._seen = set()
        self._last_hit_entry: Optional[float] = None
        self._retraces = RETRACES.labels(engine)
        self._compile_s = COMPILE_SECONDS.labels(engine)
        self._latency = STEP_LATENCY.labels(engine)
        self._interval = STEP_INTERVAL.labels(engine)

    def step(self, signature) -> _Span:
        if not _enabled:
            return _NULL_SPAN
        miss = signature not in self._seen
        if miss:
            self._seen.add(signature)
            # the flight recorder keeps the last-built signature so a
            # crash bundle can answer "what was being built when it died"
            flight.note_compile(self.engine, signature)
        else:
            now = time.perf_counter()
            if self._last_hit_entry is not None:
                self._interval.observe(now - self._last_hit_entry)
            self._last_hit_entry = now
        return _Span(self, miss)

    def _finish(self, span: _Span, dt: float):
        if span.miss:
            # the build breaks the steady-state run; restart the interval
            # chain so it doesn't pollute step time
            self._last_hit_entry = None
            self._compile_s.inc(dt)
            self._retraces.inc()
            journal.emit("retrace", engine=self.engine,
                         compile_s=round(dt, 6),
                         total=int(self._retraces.value))
        else:
            self._latency.observe(dt)
        flight.step_finished(self.engine, dt, span.miss)
        _health_tick()

    @property
    def retraces(self) -> int:
        return int(self._retraces.value)


_health_tick_fn = None


def _health_tick():
    """Any finished engine dispatch counts as liveness for the heartbeat.
    Lazy + cached: observability must not import resilience at module
    load (resilience imports observability back)."""
    global _health_tick_fn
    if _health_tick_fn is None:
        try:
            from ..resilience import health
            _health_tick_fn = health.tick
        except Exception:
            _health_tick_fn = lambda: False  # noqa: E731
    try:
        _health_tick_fn()
    except Exception:
        pass


def record_sync(seconds: float):
    """Bank wall time a host thread spent blocked on device results."""
    if _enabled:
        SYNC_SECONDS.inc(seconds)


def record_feed_stall(ms: float):
    """Bank milliseconds a consumer waited on the input feed (io.prefetch
    observes every batch, 0 included, so the mean is per-batch stall)."""
    if _enabled:
        FEED_STALL.observe(ms)
