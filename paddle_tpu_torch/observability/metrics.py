"""Thread-safe metrics registry: Counter / Gauge / Histogram with labels.

The port's own copy of paddle_tpu/observability/metrics.py (same metric
names, same series semantics, the same exposition text), so it records
into one in-process registry without importing the reference package.
Two exporters:

  * Prometheus text exposition (`to_prometheus`), which the live plane's
    /metrics serves (observability/httpd.py);
  * JSON / JSONL snapshots (`snapshot` / `to_jsonl` / `write_json`), which
    a crash bundle keeps as its metrics.json (observability/flight.py).

Pure stdlib.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "exponential_buckets", "counter", "gauge", "histogram",
]


def exponential_buckets(start: float, factor: float, count: int
                        ) -> Tuple[float, ...]:
    """`count` upper edges start, start*factor, ... (Prometheus helper)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


# default latency buckets: 100us .. ~105s
DEFAULT_BUCKETS = exponential_buckets(1e-4, 2.0, 21)


def _default_max_series() -> int:
    """Per-metric series cap (env PADDLE_TPU_METRICS_MAX_SERIES, default
    1000). An unbounded label set — a step id, a pid, a hostname leaking
    into a labelname — grows the registry forever; past the cap new
    combinations are DROPPED into a detached overflow child instead of
    raising, because a metrics call must never take down the run."""
    try:
        return max(1, int(os.environ.get(
            "PADDLE_TPU_METRICS_MAX_SERIES", "") or 1000))
    except ValueError:
        return 1000


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


class _Metric:
    """One named metric: a family of label-keyed series (children)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 max_series: Optional[int] = None, _registry=None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = int(max_series) if max_series is not None \
            else _default_max_series()
        self._lock = threading.RLock()
        self._children: Dict[Tuple[str, ...], object] = {}
        self._overflow = None       # detached sink for over-cap children
        self._dropped = 0
        self._drop_journaled = False
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        """Child series for one label-value combination."""
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            try:
                values = tuple(kv[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError(f"unknown label {e} for metric "
                                 f"{self.name!r} (has {self.labelnames})")
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {len(values)} values")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                if len(self._children) >= self.max_series:
                    # cardinality guard: hand back a detached child that
                    # absorbs the writes but is invisible to exporters —
                    # the caller keeps working, the registry stays
                    # bounded, and the drop is itself observable.
                    if self._overflow is None:
                        self._overflow = self._new_child()
                    self._dropped += 1
                    self._note_series_drop(
                        dict(zip(self.labelnames, values)))
                    return self._overflow
                child = self._children[values] = self._new_child()
            return child

    def _note_series_drop(self, labels: dict) -> None:
        """Count every refused series in pt_metrics_dropped_series_total
        and journal once per metric on the FIRST drop (one line, not one
        per call — the drop path may be the hot path that overflowed)."""
        try:
            REGISTRY.counter(
                "pt_metrics_dropped_series_total",
                "Label combinations refused by the per-metric series "
                "cardinality cap (PADDLE_TPU_METRICS_MAX_SERIES)",
            ).inc()
        except Exception:
            pass
        if self._drop_journaled:
            return
        self._drop_journaled = True
        try:
            from . import journal
            journal.emit("metrics_series_dropped", metric=self.name,
                         max_series=self.max_series, labels=labels)
        except Exception:
            pass

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} has labels {self.labelnames}; "
                "use .labels(...)")
        return self._children[()]

    def _series(self):
        with self._lock:
            items = list(self._children.items())
        for values, child in items:
            yield dict(zip(self.labelnames, values)), child


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class _GaugeChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float):
        self._default().set(value)

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def dec(self, amount: float = 1.0):
        self._default().dec(amount)

    @property
    def value(self) -> float:
        return self._default().value


class _HistogramChild:
    __slots__ = ("edges", "counts", "sum", "count", "_lock")

    def __init__(self, edges):
        self.edges = edges              # sorted upper edges, +Inf implicit
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float):
        v = float(value)
        # Prometheus buckets are upper-INCLUSIVE: v == edge lands in that
        # bucket (bisect_left: first edge >= v)
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count), ...] ending with (+Inf, total)."""
        out = []
        acc = 0
        with self._lock:
            counts = list(self.counts)
        for le, c in zip(tuple(self.edges) + (math.inf,), counts):
            acc += c
            out.append((le, acc))
        return out


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None,
                 max_series=None):
        bks = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        if len(set(bks)) != len(bks):
            raise ValueError("duplicate bucket edges")
        self.buckets = bks
        super().__init__(name, help, labelnames, max_series)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float):
        self._default().observe(value)

    @property
    def sum(self):
        return self._default().sum

    @property
    def count(self):
        return self._default().count

    @property
    def mean(self):
        return self._default().mean


class MetricsRegistry:
    """Name -> metric table; get-or-create accessors are the public API so
    call sites never race on registration (the analogue of the reference's
    singleton profiler state, but typed and label-aware)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help,
                                              labelnames=labelnames, **kw)
                return m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        if tuple(labelnames) != m.labelnames:
            raise ValueError(
                f"metric {name!r} registered with labels {m.labelnames}, "
                f"requested {tuple(labelnames)}")
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def reset(self):
        """Drop every metric (tests / bench isolation)."""
        with self._lock:
            self._metrics.clear()

    def _sorted(self):
        with self._lock:
            return sorted(self._metrics.items())

    # -- exporters -----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serializable dump of every series."""
        out = {}
        for name, m in self._sorted():
            series = []
            for lbls, child in m._series():
                if m.kind == "histogram":
                    # +Inf serialized as a string so the dump is STRICT
                    # JSON (json.dumps would emit the nonstandard Infinity)
                    series.append({"labels": lbls, "sum": child.sum,
                                   "count": child.count,
                                   "buckets": [
                                       [("+Inf" if le == math.inf else le),
                                        c]
                                       for le, c in child.cumulative()]})
                else:
                    series.append({"labels": lbls, "value": child.value})
            out[name] = {"type": m.kind, "help": m.help,
                         "labelnames": list(m.labelnames), "series": series}
        return out

    def to_jsonl(self) -> str:
        """One JSON line per series (grep-able snapshot flavor)."""
        lines = []
        for name, meta in self.snapshot().items():
            for s in meta["series"]:
                lines.append(json.dumps({"name": name,
                                         "type": meta["type"], **s}))
        return "\n".join(lines) + ("\n" if lines else "")

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out = []

        def lblstr(lbls, extra=()):
            items = [(k, v) for k, v in lbls.items()] + list(extra)
            if not items:
                return ""
            return ("{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items)
                    + "}")

        for name, m in self._sorted():
            if m.help:
                out.append(f"# HELP {name} {_escape(m.help)}")
            out.append(f"# TYPE {name} {m.kind}")
            for lbls, child in m._series():
                if m.kind == "histogram":
                    for le, c in child.cumulative():
                        out.append(f"{name}_bucket"
                                   f"{lblstr(lbls, [('le', _fmt(le))])} {c}")
                    out.append(f"{name}_sum{lblstr(lbls)} "
                               f"{_fmt(child.sum)}")
                    out.append(f"{name}_count{lblstr(lbls)} {child.count}")
                else:
                    out.append(f"{name}{lblstr(lbls)} {_fmt(child.value)}")
        return "\n".join(out) + ("\n" if out else "")

    def write_json(self, path: str):
        with open(path, "w") as f:
            json.dump({"ts": time.time(), "metrics": self.snapshot()}, f,
                      indent=1, default=lambda o: str(o))
        return path


#: process-wide default registry — every subsystem records here
REGISTRY = MetricsRegistry()


def counter(name, help="", labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets)
