"""Span tracing: wall-time decomposition of serving requests.

The port's copy of the parts of paddle_tpu/observability/spans.py the
serving scheduler calls. A span is one named wall-clock interval with an
optional parent, so a serving request decomposes into `queue_wait` /
`prefill` / `decode_steps`.

  * ``begin(name, ...)`` / ``end(handle, ...)`` — explicit pair for spans
    that START on one thread and FINISH on another (a serving request
    begins in the caller's ``submit()`` and ends in the worker loop).
  * ``record(name, dur_ms, ...)`` — bank an interval measured by the
    caller's own clock (the scheduler computes queue_wait/prefill from its
    injectable clock so children sum EXACTLY to ttft_s).

Every recorded span observes ``pt_span_ms{name=...}`` and, when a run
journal is active, emits a ``span`` journal event
(`name/dur_ms/parent/trace/attrs`). Trace ids come from
``PADDLE_TPU_TRACE_ID`` so one multi-process run correlates; standalone
processes mint their own.

With telemetry off (``PADDLE_TPU_TELEMETRY=0`` or
``tracing.enable(False)``) every entry point is a no-op.
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Optional

from . import journal, metrics, tracing

__all__ = ["begin", "end", "record", "trace_id", "Span", "SPAN_MS"]

# millisecond scale: 10us .. ~84s upper edges
SPAN_MS = metrics.histogram(
    "pt_span_ms",
    "Wall time of named trace spans, milliseconds",
    labelnames=("name",),
    buckets=metrics.exponential_buckets(0.01, 2.0, 24))

_trace_id: Optional[str] = None


def trace_id() -> str:
    """Run-scoped correlation id: launcher-exported env, else per-process."""
    global _trace_id
    if _trace_id is None:
        _trace_id = (os.environ.get("PADDLE_TPU_TRACE_ID")
                     or uuid.uuid4().hex[:12])
    return _trace_id


def _emit(name: str, dur_ms: float, parent: Optional[str], attrs) -> None:
    SPAN_MS.labels(name).observe(dur_ms)
    # journal writes only when a run journal is live
    if journal.get_journal() is not None:
        # tid gives one track per rank x thread (the envelope already
        # carries rank/pid)
        ev = {"name": name, "dur_ms": round(dur_ms, 3), "trace": trace_id(),
              "tid": threading.get_ident() % 100000}
        if parent:
            ev["parent"] = parent
        if attrs:
            ev["attrs"] = attrs
        journal.emit("span", **ev)


class Span:
    """One open interval: a begin()/end() handle."""

    __slots__ = ("name", "parent", "attrs", "t0", "_done")

    def __init__(self, name: str, parent: Optional[str], attrs: dict):
        self.name = name
        self.parent = parent
        self.attrs = attrs
        self._done = False
        self.t0 = time.perf_counter()


def begin(name: str, parent: Optional[str] = None, **attrs
          ) -> Optional[Span]:
    """Start a cross-thread span; pair with ``end(handle)`` anywhere.
    Returns None when tracing is disabled (end(None) is a no-op), so call
    sites need no enabled() check of their own."""
    if not tracing.enabled():
        return None
    return Span(name, parent, attrs)


def end(handle: Optional[Span], **attrs) -> None:
    """Finish a begin() handle (any thread). Extra attrs merge in."""
    if handle is None or handle._done:
        return
    handle._done = True
    if attrs:
        handle.attrs = {**handle.attrs, **attrs}
    _emit(handle.name, (time.perf_counter() - handle.t0) * 1e3,
          handle.parent, handle.attrs)


def record(name: str, dur_ms: float, parent: Optional[str] = None,
           **attrs) -> None:
    """Bank a caller-measured interval as a span (no clock reads here)."""
    if not tracing.enabled():
        return
    _emit(name, float(dur_ms), parent, attrs)
