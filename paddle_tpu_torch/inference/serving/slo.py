"""SLO control plane: admission control + load shedding for serving.

The port's host-only copy of paddle_tpu/inference/serving/slo.py. At
3x offered load an unbounded `ContinuousBatcher.waiting` deque exhibits
classic queueing collapse — every request is "admitted" and every
request blows its latency budget. This module turns the same telemetry
into the control signal:

  * `WindowedPercentile` — sliding-window online percentile estimator
    fed from the scheduler's own TTFT samples (bounded count + age, so
    the live p99 tracks the CURRENT overload, not the whole run).
  * `SLOPolicy` — the budget: fleet TTFT-p99 target, per-request
    deadline, and the queue bound. `SLOPolicy.from_env()` reads
    PADDLE_TPU_SLO_TTFT_MS (+ optional PADDLE_TPU_MAX_QUEUE_DEPTH) and
    returns None while the TTFT budget is unset — the whole plane is
    off by default and submit/step behavior stays byte-identical to a
    policy-free build.
  * `AdmissionController` — the healthy -> shedding -> brownout state
    machine. Decisions are enforced at `ContinuousBatcher.submit()`
    (bounded queue, reject with a computed `retry_after_s`) and at
    admission time (drop queued requests whose deadline already
    expired, with a `serve_shed{reason}` journal event instead of a
    silent timeout).

Reject-with-retry-after beats queueing collapse: a shed request costs
the caller one cheap retry; an admitted-then-expired request costs a
prefill plus decode steps that can never meet their deadline and
steals those steps from requests that still could.
"""
from __future__ import annotations

import os
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Optional

from ...observability import metrics

__all__ = ["ShedError", "SLOPolicy", "WindowedPercentile",
           "AdmissionController", "VirtualClock",
           "STATE_HEALTHY", "STATE_SHEDDING", "STATE_BROWNOUT",
           "ENV_SLO_TTFT_MS", "ENV_MAX_QUEUE_DEPTH"]

ENV_SLO_TTFT_MS = "PADDLE_TPU_SLO_TTFT_MS"
ENV_MAX_QUEUE_DEPTH = "PADDLE_TPU_MAX_QUEUE_DEPTH"

STATE_HEALTHY = "healthy"
STATE_SHEDDING = "shedding"
STATE_BROWNOUT = "brownout"
_STATE_CODE = {STATE_HEALTHY: 0, STATE_SHEDDING: 1, STATE_BROWNOUT: 2}

SHED = metrics.counter(
    "pt_serve_shed_total",
    "Requests rejected or dropped by admission control",
    labelnames=("reason",))
DEADLINE_EXPIRED = metrics.counter(
    "pt_serve_deadline_expired_total",
    "Queued requests dropped at admission because their deadline passed")
P99_MS = metrics.gauge(
    "pt_slo_ttft_p99_ms",
    "Live sliding-window TTFT p99 (the admission control signal)")
BUDGET_MS = metrics.gauge(
    "pt_slo_ttft_budget_ms", "Configured fleet TTFT-p99 budget")
ADMISSION_STATE = metrics.gauge(
    "pt_admission_state",
    "Admission state machine: 0 healthy, 1 shedding, 2 brownout")
QUEUE_LIMIT = metrics.gauge(
    "pt_slo_max_queue_depth",
    "Configured admission queue bound (headroom = limit - queue_depth)")


class ShedError(RuntimeError):
    """Request rejected by admission control — retry after a delay.

    Deliberately NOT a server failure: callers distinguish a shedding
    (degraded-but-alive) replica from a dead serving loop by catching
    this type and honoring `retry_after_s`.
    """

    def __init__(self, reason: str, retry_after_s: float,
                 state: str = STATE_HEALTHY):
        super().__init__(
            "request shed (%s, admission state %s): retry after %.3fs"
            % (reason, state, retry_after_s))
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        self.state = state


class VirtualClock:
    """Injectable fake clock: `clock()` reads it, `sleep()` advances it.

    Passed as `ContinuousBatcher(clock=...)` / `run_open_loop(clock=...)`
    so overload benches and SLO tests run open-loop arrival schedules
    fast and deterministically on CPU CI — no `time.sleep` in the hot
    loop, and queueing delay becomes pure arithmetic."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self.now += seconds

    def advance(self, seconds: float) -> None:
        self.now += float(seconds)


class WindowedPercentile:
    """Sliding-window online percentile over the most recent samples.

    Bounded by count (`window`) and optionally by age (`max_age_s`):
    a sample falls out once `window` newer samples arrived OR once it
    is older than `max_age_s` by the supplied clock — so the estimate
    tracks the current regime, not the run-lifetime distribution the
    `pt_serve_ttft_seconds` histogram accumulates.

    `quantile(q)` matches numpy's default linear interpolation
    (`numpy.quantile(window, q)`) exactly over the live window; windows
    are control-loop sized (hundreds), so the sort-per-query cost is
    noise next to a prefill dispatch.

    Thread-safe: the server shares one AdmissionController across all
    worker threads, so observe() (append/popleft) and quantile()/mean()
    (iteration) race on the same deque — concurrent mutation during
    iteration raises RuntimeError and would kill a worker loop. A
    single lock around every touch of `_samples` keeps the window
    consistent; contention is one dict-sized critical section per
    request, invisible next to a prefill.
    """

    def __init__(self, window: int = 256,
                 max_age_s: Optional[float] = None):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = int(window)
        self.max_age_s = max_age_s
        self._samples: deque = deque()     # (ts, value), oldest first
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def observe(self, value: float, now: Optional[float] = None) -> None:
        ts = time.perf_counter() if now is None else float(now)
        with self._lock:
            self._samples.append((ts, float(value)))
            self._evict_locked(ts)

    def _evict_locked(self, now: float) -> None:
        # caller holds self._lock
        while len(self._samples) > self.window:
            self._samples.popleft()
        if self.max_age_s is not None:
            cutoff = now - self.max_age_s
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()

    def quantile(self, q: float,
                 now: Optional[float] = None) -> Optional[float]:
        """Linear-interpolated quantile of the live window (numpy's
        default method), or None while the window is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            if now is not None:
                self._evict_locked(float(now))
            if not self._samples:
                return None
            vs = sorted(v for _, v in self._samples)
        if len(vs) == 1:
            return vs[0]
        pos = q * (len(vs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vs) - 1)
        frac = pos - lo
        return vs[lo] + frac * (vs[hi] - vs[lo])

    def mean(self) -> Optional[float]:
        with self._lock:
            if not self._samples:
                return None
            return sum(v for _, v in self._samples) / len(self._samples)


@dataclass(frozen=True)
class SLOPolicy:
    """The budget the control loop enforces.

    `ttft_budget_ms` is the fleet p99 TTFT target; `deadline_ms` is the
    per-request deadline (defaults to 4x the budget — a request that
    waited that long can no longer contribute to goodput and is dropped
    at admission instead of wasting a prefill). `max_queue_depth`
    bounds `ContinuousBatcher.waiting`; under SHEDDING the effective
    bound halves and under BROWNOUT only an empty queue admits, so the
    backlog drains instead of compounding.
    """

    ttft_budget_ms: float
    deadline_ms: Optional[float] = None
    max_queue_depth: int = 64
    window: int = 256
    window_age_s: Optional[float] = 60.0
    min_samples: int = 8            # stay healthy until the signal is real
    recover_frac: float = 0.8       # leave shedding below 0.8x budget
    brownout_factor: float = 2.0    # enter brownout above 2x budget

    def __post_init__(self):
        if self.ttft_budget_ms <= 0:
            raise ValueError("ttft_budget_ms must be > 0")
        if self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")

    @property
    def deadline_s(self) -> float:
        ms = self.deadline_ms if self.deadline_ms is not None \
            else 4.0 * self.ttft_budget_ms
        return ms / 1e3

    @classmethod
    def from_env(cls, env=os.environ) -> Optional["SLOPolicy"]:
        """Policy from PADDLE_TPU_SLO_TTFT_MS (+ optional
        PADDLE_TPU_MAX_QUEUE_DEPTH), or None when the TTFT budget is
        unset — the parity contract: no budget knob, no policy, no
        behavior change (queue depth alone never activates a policy).

        A set-but-unparsable value is an operator typo, and silently
        returning None would disable overload protection with no
        signal — so it warns loudly instead."""
        raw = env.get(ENV_SLO_TTFT_MS, "").strip()
        if not raw:
            return None
        try:
            budget = float(raw)
        except ValueError:
            warnings.warn(
                "%s=%r is not a number; SLO admission control DISABLED"
                % (ENV_SLO_TTFT_MS, raw), RuntimeWarning, stacklevel=2)
            return None
        if budget <= 0:
            warnings.warn(
                "%s=%r must be > 0; SLO admission control DISABLED"
                % (ENV_SLO_TTFT_MS, raw), RuntimeWarning, stacklevel=2)
            return None
        kw = {}
        raw_q = env.get(ENV_MAX_QUEUE_DEPTH, "").strip()
        if raw_q:
            try:
                kw["max_queue_depth"] = max(1, int(raw_q))
            except ValueError:
                warnings.warn(
                    "%s=%r is not an integer; using default queue depth"
                    % (ENV_MAX_QUEUE_DEPTH, raw_q),
                    RuntimeWarning, stacklevel=2)
        return cls(ttft_budget_ms=budget, **kw)


class AdmissionController:
    """healthy -> shedding -> brownout, driven by the live TTFT p99.

    Transitions (evaluated on every observation and every decision):

      healthy  -> shedding  once p99 > budget (with >= min_samples)
      shedding -> brownout  once p99 > brownout_factor x budget
      brownout -> shedding  once p99 <= brownout_factor x budget
      shedding -> healthy   once p99 <  recover_frac x budget

    Admission per state: HEALTHY sheds only a full queue
    (`queue_full`); SHEDDING halves the effective queue bound
    (`slo_breach`) so the backlog drains; BROWNOUT admits only into an
    empty queue (`brownout`) — a trickle that keeps the p99 signal
    alive so recovery can be observed. `retry_after_s` is the estimated
    backlog drain time (queued x windowed mean TTFT, floored at 10ms),
    so callers back off proportionally to the actual congestion.

    Thread-safety: the server shares ONE controller across all worker
    threads. The sample windows are internally locked (see
    `WindowedPercentile`), so concurrent observe/quantile calls are
    safe. The state machine and shed counters themselves are updated
    without a lock: a torn read there costs at most one request shed or
    admitted a step late — acceptable for a control loop — whereas a
    torn window iteration would raise and kill a worker.

    Note `check_admit` takes the CALLER's queue depth: each batcher
    passes its own `len(waiting)`, so with `workers` > 1 the bound is
    per-worker and the replica-wide backlog cap is
    `workers x max_queue_depth` (documented in SERVING.md).
    """

    def __init__(self, policy: SLOPolicy, clock=time.perf_counter):
        self.policy = policy
        self._clock = clock
        self.ttft = WindowedPercentile(window=policy.window,
                                       max_age_s=policy.window_age_s)
        self.queue_wait = WindowedPercentile(window=policy.window,
                                             max_age_s=policy.window_age_s)
        self.state = STATE_HEALTHY
        self.shed_counts: dict = {}
        self.admitted = 0
        BUDGET_MS.set(policy.ttft_budget_ms)
        QUEUE_LIMIT.set(policy.max_queue_depth)
        ADMISSION_STATE.set(0)
        P99_MS.set(0.0)

    # -- signal ------------------------------------------------------------

    def observe_ttft(self, ttft_s: float) -> None:
        self.ttft.observe(float(ttft_s), now=self._clock())
        self._update_state()

    def observe_queue_wait(self, wait_s: float) -> None:
        self.queue_wait.observe(float(wait_s), now=self._clock())

    def p99_ms(self) -> Optional[float]:
        p = self.ttft.quantile(0.99, now=self._clock())
        return None if p is None else p * 1e3

    def _update_state(self) -> str:
        p99 = self.p99_ms()
        if p99 is not None:
            P99_MS.set(round(p99, 3))
        budget = self.policy.ttft_budget_ms
        if p99 is None or len(self.ttft) < self.policy.min_samples:
            pass                     # not enough signal to leave healthy
        elif p99 > self.policy.brownout_factor * budget:
            self.state = STATE_BROWNOUT
        elif p99 > budget:
            # entering shed from healthy, or stepping down from brownout
            self.state = STATE_SHEDDING
        elif self.state is not STATE_HEALTHY \
                and p99 < self.policy.recover_frac * budget:
            self.state = STATE_HEALTHY
        elif self.state is STATE_BROWNOUT:
            self.state = STATE_SHEDDING
        ADMISSION_STATE.set(_STATE_CODE[self.state])
        return self.state

    # -- actuation ---------------------------------------------------------

    def retry_after_s(self, queue_depth: int) -> float:
        """Estimated backlog drain time: how long until a retry would
        land in a queue with headroom."""
        est = self.ttft.mean() or self.queue_wait.mean() \
            or self.policy.ttft_budget_ms / 1e3
        return max(0.01, round((queue_depth + 1) * est, 3))

    def check_admit(self, queue_depth: int) -> Optional[ShedError]:
        """None to admit, else the ShedError to raise — called by
        `ContinuousBatcher.submit()` BEFORE the request queues."""
        state = self._update_state()
        limit = self.policy.max_queue_depth
        reason = None
        if state is STATE_BROWNOUT and queue_depth > 0:
            reason = "brownout"
        elif state is STATE_SHEDDING and queue_depth >= max(1, limit // 2):
            reason = "slo_breach"
        elif queue_depth >= limit:
            reason = "queue_full"
        if reason is None:
            self.admitted += 1
            return None
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1
        SHED.labels(reason).inc()
        return ShedError(reason, self.retry_after_s(queue_depth),
                         state=state)

    def deadline_ts(self, submit_ts: float) -> float:
        return submit_ts + self.policy.deadline_s

    def expire(self, req_submit_ts: float) -> bool:
        """True iff a queued request's deadline has passed (checked by
        `_admit` just before spending a prefill on it)."""
        if self._clock() < self.deadline_ts(req_submit_ts):
            return False
        reason = "deadline_expired"
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1
        SHED.labels(reason).inc()
        DEADLINE_EXPIRED.inc()
        return True

    def status(self, queue_depth: int = 0) -> dict:
        """The /statusz `slo` block (httpd.py attaches this via
        register_status)."""
        p99 = self.p99_ms()
        shed = sum(self.shed_counts.values())
        seen = self.admitted + shed
        return {
            "state": self.state,
            "ttft_budget_ms": self.policy.ttft_budget_ms,
            "ttft_p99_ms": None if p99 is None else round(p99, 3),
            "deadline_ms": round(self.policy.deadline_s * 1e3, 3),
            "window_samples": len(self.ttft),
            "shed_total": shed,
            "shed_by_reason": dict(sorted(self.shed_counts.items())),
            "shed_rate": round(shed / seen, 4) if seen else 0.0,
            "queue_depth": queue_depth,
            "queue_headroom": max(0,
                                  self.policy.max_queue_depth - queue_depth),
        }
