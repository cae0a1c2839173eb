"""Retry and deadline primitives (the port's copy of
paddle_tpu/resilience/retry.py).

`RetryPolicy` is one bounded retry loop: exponential backoff with
deterministic jitter and a hard wall-clock deadline, so that no retry loop
outlives its caller's budget. `with_deadline` bounds one slow call. Each
failed attempt that `RetryPolicy.call` retries counts in
`pt_retry_attempts_total{site}` and lands in the run journal as a `retry`
event, as in the reference.

Standard library only.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type


def _observe_retry(site: str, attempt: int, error: BaseException):
    """Best-effort telemetry: when this module is loaded on its own (no
    package parent) the relative import fails, and the attempt goes
    uncounted."""
    try:
        from ..observability import journal, metrics
    except Exception:
        return
    try:
        metrics.counter("pt_retry_attempts_total",
                        "Failed attempts retried, by call site",
                        labelnames=("site",)).labels(site).inc()
        journal.emit("retry", site=site, attempt=attempt,
                     error=repr(error))
    except Exception:
        pass


class DeadlineExceeded(TimeoutError):
    """A wall-clock deadline expired before the operation completed."""


class RetryExhausted(RuntimeError):
    """All retry attempts failed; `.last_error` holds the final cause."""

    def __init__(self, msg, last_error=None):
        super().__init__(msg)
        self.last_error = last_error


class RetryPolicy:
    """Bounded retry loop: exponential backoff + jitter + hard deadline.

        policy = RetryPolicy(max_tries=8, base_delay=1.0, deadline_s=600)
        for attempt in policy.attempts():
            if try_thing():
                break
        else:
            ...  # exhausted (max_tries or deadline)

    or the functional form::

        result = policy.call(fragile_fn, retry_on=(OSError,))

    The deadline is wall-clock from the policy's first attempt and bounds
    the TOTAL loop (sleeps are clipped to the remaining budget; an attempt
    never starts with the deadline already spent). Jitter is deterministic
    per policy instance (seeded) so tests and injected-fault runs replay
    exactly.
    """

    def __init__(self, max_tries: Optional[int] = None,
                 base_delay: float = 1.0, multiplier: float = 2.0,
                 max_delay: float = 60.0, jitter: float = 0.1,
                 deadline_s: Optional[float] = None, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if max_tries is None and deadline_s is None:
            raise ValueError("RetryPolicy needs max_tries and/or deadline_s "
                             "— an unbounded loop is the bug this class "
                             "exists to prevent")
        self.max_tries = max_tries
        self.base_delay = float(base_delay)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.deadline_s = deadline_s
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock
        self._t0: Optional[float] = None
        self.tries = 0

    def backoff(self, attempt: int) -> float:
        """Planned sleep BEFORE retry `attempt` (attempt 0 never sleeps).
        Indices past the configured schedule are CLAMPED, not an error: a
        runaway index saturates at max_delay instead of overflowing the
        float exponent."""
        if attempt <= 0:
            return 0.0
        if self.max_tries is not None:
            attempt = min(attempt, self.max_tries)
        try:
            d = min(self.base_delay * self.multiplier ** (attempt - 1),
                    self.max_delay)
        except OverflowError:
            d = self.max_delay
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def remaining(self) -> float:
        """Wall-clock budget left; +inf when no deadline is set."""
        if self.deadline_s is None:
            return float("inf")
        if self._t0 is None:
            return float(self.deadline_s)
        return self.deadline_s - (self._clock() - self._t0)

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def attempts(self) -> Iterator[int]:
        """Yield attempt indices 0, 1, ... sleeping (backoff, clipped to
        the remaining deadline) before each retry. Stops when max_tries is
        reached or the deadline would be spent before the next attempt."""
        self._t0 = self._clock()
        attempt = 0
        while self.max_tries is None or attempt < self.max_tries:
            if attempt:
                delay = self.backoff(attempt)
                rem = self.remaining()
                if rem <= 0.0:
                    return
                self._sleep(min(delay, rem))
            if self.expired():
                return
            self.tries = attempt + 1
            yield attempt
            attempt += 1

    def call(self, fn: Callable, *args,
             retry_on: Tuple[Type[BaseException], ...] = (Exception,),
             on_error: Optional[Callable[[int, BaseException], None]] = None,
             site: str = "",
             **kwargs):
        """Run `fn` under the policy; return its first successful result.
        Raises RetryExhausted (chaining the last error) on exhaustion.
        `site` labels the retry in telemetry (defaults to fn's name)."""
        last: Optional[BaseException] = None
        site = site or getattr(fn, "__name__", "call")
        for attempt in self.attempts():
            try:
                return fn(*args, **kwargs)
            except retry_on as e:
                last = e
                _observe_retry(site, attempt, e)
                if on_error is not None:
                    on_error(attempt, e)
        raise RetryExhausted(
            "retry exhausted after %d tries (deadline_s=%s): %s"
            % (self.tries, self.deadline_s, last), last_error=last) from last


def with_deadline(fn: Callable, timeout_s: float, *args, context: str = "",
                  **kwargs):
    """Run `fn(*args, **kwargs)` with a hard wall-clock deadline.

    The call runs in a daemon worker thread; on timeout DeadlineExceeded is
    raised in the caller. The worker cannot be force-killed (CPython), so
    `fn` may keep running detached — callers for whom a leaked hung call is
    unacceptable should run it in a timed child process instead; this
    helper is for bounding calls that are slow, not wedged."""
    import threading

    box = {}
    done = threading.Event()

    def run():
        try:
            box["result"] = fn(*args, **kwargs)
        except BaseException as e:  # surfaced in the caller below
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True,
                         name="with_deadline(%s)" % (context or
                                                     getattr(fn, "__name__",
                                                             "fn")))
    t.start()
    if not done.wait(timeout_s):
        raise DeadlineExceeded(
            "%s did not complete within %.1fs"
            % (context or getattr(fn, "__name__", "call"), timeout_s))
    if "error" in box:
        raise box["error"]
    return box.get("result")
