"""Span tracing: wall-time decomposition of train steps and serving
requests.

The port's copy of the parts of paddle_tpu/observability/spans.py that
Model.fit and the serving scheduler call. A span is one named wall-clock
interval with an optional parent, so a fit step decomposes into `feed` /
`compile` / `host` under `step`, and a serving request into `queue_wait` /
`prefill` / `decode_steps`.

  * ``span(name, ...)`` — context manager, nested per thread (the
    innermost open span is the parent); ``.cancel()`` abandons it
    unrecorded, and an exception unwinding through it records nothing.
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

__all__ = ["span", "current", "begin", "end", "record", "trace_id", "Span",
           "SPAN_MS"]

# millisecond scale: 10us .. ~84s upper edges
SPAN_MS = metrics.histogram(
    "pt_span_ms",
    "Wall time of named trace spans, milliseconds",
    labelnames=("name",),
    buckets=metrics.exponential_buckets(0.01, 2.0, 24))

_trace_id: Optional[str] = None
_tls = threading.local()


def trace_id() -> str:
    """Run-scoped correlation id: launcher-exported env, else per-process."""
    global _trace_id
    if _trace_id is None:
        _trace_id = (os.environ.get("PADDLE_TPU_TRACE_ID")
                     or uuid.uuid4().hex[:12])
    return _trace_id


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current() -> Optional[str]:
    """Name of the innermost open span on THIS thread (else None)."""
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


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
    """One open interval: a context manager (stacked) or a begin()/end()
    handle."""

    __slots__ = ("name", "parent", "attrs", "t0", "_stacked", "_done")

    def __init__(self, name: str, parent: Optional[str], attrs: dict,
                 stacked: bool = False):
        self.name = name
        self.parent = parent
        self.attrs = attrs
        self._stacked = stacked
        self._done = False
        self.t0 = time.perf_counter()

    def cancel(self) -> None:
        """Abandon without recording (the feed-exhausted last step)."""
        self._done = True

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._stacked:
            s = _stack()
            if s and s[-1] is self.name:
                s.pop()
        if not self._done:
            self._done = True
            # an exception unwinding through the block is not a measured
            # interval
            if exc_type is None:
                _emit(self.name, (time.perf_counter() - self.t0) * 1e3,
                      self.parent, self.attrs)
        return False


class _NullSpan:
    """Shared no-op for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def cancel(self) -> None:
        pass


_NULL = _NullSpan()


def span(name: str, **attrs):
    """Open a nested span on this thread: ``with spans.span("step"): ...``"""
    if not tracing.enabled():
        return _NULL
    s = _stack()
    sp = Span(name, s[-1] if s else None, attrs, stacked=True)
    s.append(name)
    return sp


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
