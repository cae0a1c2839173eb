"""Continuous-batching scheduler over the generation engine's slots.

The port's host-only copy of paddle_tpu/inference/serving/scheduler.py.
Orca-style iteration-level scheduling: the decode batch is a fixed set
of `max_batch` slots; a finished sequence frees its slot at the end of
the step and a queued request is admitted into it on the next step via
one bucketed prefill — the batch stays full instead of draining to the
slowest straggler. `admit_mid_flight=False` degrades to classic static
batching (fill the batch, run it to empty, repeat), kept as the
baseline arm of the bench comparison in benchmarks/inference_bench.py.

All decode dispatches cost the same wall time regardless of how many
slots are live (the compiled program is shape-fixed), so throughput is
decided purely by how many useful tokens each step carries — which is
exactly what `pt_serve_batch_occupancy` measures.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ...observability import journal, metrics, spans
from .slo import AdmissionController, ShedError, SLOPolicy

__all__ = ["Request", "ContinuousBatcher", "run_open_loop"]

ADMITTED = metrics.counter(
    "pt_serve_admitted_total", "Requests admitted into a decode slot")
COMPLETED = metrics.counter(
    "pt_serve_completed_total",
    "Requests finished (max_new_tokens reached or eos emitted)")
TOKENS = metrics.counter(
    "pt_serve_tokens_total",
    "Tokens generated for live requests (prefill first tokens included)")
OCCUPANCY = metrics.gauge(
    "pt_serve_batch_occupancy",
    "Live slots in the decode batch after the latest scheduler step")
TTFT = metrics.histogram(
    "pt_serve_ttft_seconds", "Submit-to-first-token latency per request")
REQ_SECONDS = metrics.histogram(
    "pt_serve_request_seconds", "Submit-to-completion latency per request")

_RID = itertools.count(1)


@dataclass
class Request:
    """One generation request and its measured lifecycle."""

    prompt: Sequence[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    rid: int = field(default_factory=lambda: next(_RID))
    tokens: List[int] = field(default_factory=list)
    submit_ts: Optional[float] = None     # set at batcher.submit()
    ttft_s: Optional[float] = None        # submit -> first token
    latency_s: Optional[float] = None     # submit -> completion
    slot: Optional[int] = None
    prefix_len: int = 0                   # cached-prefix tokens reused
    on_complete: Optional[Callable[["Request"], None]] = None
    span: Optional[object] = None         # serve_request spans.begin handle
    outcome: Optional[str] = None         # completed|shed|deadline_expired
    error: Optional[BaseException] = None  # ShedError when shed/expired

    @property
    def done(self) -> bool:
        if len(self.tokens) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and len(self.tokens) > 0
                and self.tokens[-1] == self.eos_id)


class ContinuousBatcher:
    """Slot scheduler driving one GenerationEngine.

    step() == admit waiting requests into free slots (one prefill each,
    which also yields the request's first token / TTFT), then one decode
    dispatch for the whole batch, then harvest + free finished slots.
    """

    def __init__(self, engine, admit_mid_flight: bool = True,
                 clock=time.perf_counter, slo=None):
        self.engine = engine
        self.admit_mid_flight = admit_mid_flight
        self._clock = clock
        # SLO admission control: an SLOPolicy (wrapped
        # in a controller on the batcher's own clock) or a shared
        # AdmissionController (the threaded server passes one across
        # all workers). None — the default — keeps submit/step behavior
        # byte-identical to a policy-free build: unbounded queue, no
        # deadlines, `serve_shed` never fires.
        if isinstance(slo, SLOPolicy):
            slo = AdmissionController(slo, clock=clock)
        self.slo: Optional[AdmissionController] = slo
        self.waiting: deque = deque()
        self.slots: List[Optional[Request]] = [None] * engine.max_batch
        self.steps = 0
        self.live_slot_steps = 0

    # -- introspection ----------------------------------------------------

    @property
    def active(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    @property
    def idle(self) -> bool:
        return not self.waiting and self.active == 0

    @property
    def occupancy_mean(self) -> float:
        if not self.steps:
            return 0.0
        return self.live_slot_steps / (self.steps * self.engine.max_batch)

    def pending_requests(self) -> List[Request]:
        return [r for r in self.slots if r is not None] + list(self.waiting)

    # -- lifecycle --------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Queue a request; validates it fits the engine's static shapes."""
        prompt = np.asarray(req.prompt, np.int64).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # single source of truth for bucketing lives in serving/cache.py;
        # the engine method is its thin delegate
        self.engine.bucket_for(int(prompt.shape[0]))
        if prompt.shape[0] + req.max_new_tokens > self.engine.max_seq_len:
            raise ValueError(
                "prompt (%d) + max_new_tokens (%d) exceeds max_seq_len %d"
                % (prompt.shape[0], req.max_new_tokens,
                   self.engine.max_seq_len))
        if req.submit_ts is None:
            req.submit_ts = self._clock()
        if req.span is None:
            # direct-batcher callers get the root span here; the threaded
            # server begins it earlier, in the submitter's own thread
            req.span = spans.begin("serve_request", rid=req.rid)
        if self.slo is not None:
            err = self.slo.check_admit(len(self.waiting))
            if err is not None:
                self._shed(req, err, queued=False)
                raise err
        self.waiting.append(req)
        return req

    def _shed(self, req: Request, err: ShedError, queued: bool) -> None:
        """Reject a request (at submit) or drop it (expired in queue):
        end its span with the shed outcome and journal the decision —
        a named `serve_shed` beats a silent timeout."""
        req.outcome = err.reason if err.reason == "deadline_expired" \
            else "shed"
        req.error = err
        spans.end(req.span, outcome=req.outcome, reason=err.reason)
        journal.emit("serve_shed", rid=req.rid, reason=err.reason,
                     state=err.state,
                     retry_after_s=round(err.retry_after_s, 3),
                     queue_depth=len(self.waiting),
                     waited_s=round(self._clock() - req.submit_ts, 6))
        if queued and req.on_complete is not None:
            # a queued-then-expired request still owes its caller an
            # answer; submit-time rejects answer via the raised error
            req.on_complete(req)

    def _complete(self, req: Request, completed: List[Request]) -> None:
        req.latency_s = self._clock() - req.submit_ts
        req.slot = None
        req.outcome = "completed"
        COMPLETED.inc()
        REQ_SECONDS.observe(req.latency_s)
        if len(req.tokens) > 1:
            # everything after the first token: latency - ttft by the
            # scheduler's own clock, so the three children sum to latency
            spans.record("decode_steps",
                         (req.latency_s - req.ttft_s) * 1e3,
                         parent="serve_request", rid=req.rid,
                         steps=len(req.tokens) - 1)
        spans.end(req.span, tokens=len(req.tokens), outcome="completed")
        journal.emit("serve_complete", rid=req.rid,
                     tokens=len(req.tokens),
                     ttft_s=round(req.ttft_s, 6),
                     latency_s=round(req.latency_s, 6))
        completed.append(req)
        if req.on_complete is not None:
            req.on_complete(req)

    def _admit(self, completed: List[Request]) -> None:
        # static batching only refills once the whole batch has drained
        if not self.admit_mid_flight and self.active > 0:
            return
        for slot, r in enumerate(self.slots):
            if self.slo is not None:
                # drop expired waiters BEFORE spending a prefill on
                # them: past its deadline a request can only steal
                # decode steps from ones that could still make theirs
                while self.waiting and \
                        self.slo.expire(self.waiting[0].submit_ts):
                    expired = self.waiting.popleft()
                    self._shed(expired, ShedError(
                        "deadline_expired",
                        self.slo.retry_after_s(len(self.waiting)),
                        state=self.slo.state), queued=True)
                    completed.append(expired)
            if not self.waiting:
                return
            if r is not None:
                continue
            req = self.waiting.popleft()
            n = len(np.asarray(req.prompt).reshape(-1))
            t_pre = self._clock()
            tok = self.engine.prefill(slot, req.prompt)
            now = self._clock()
            req.ttft_s = now - req.submit_ts
            # what THIS admission actually dispatched: on a prefix hit
            # the bucket is the (smaller) suffix bucket and prefix_len
            # counts the reused tokens
            info = getattr(self.engine, "admit_info", None) or \
                {"prefix_len": 0, "bucket": self.engine.bucket_for(n)}
            req.prefix_len = int(info.get("prefix_len", 0))
            # queue_wait + prefill == ttft_s exactly: same clock, same
            # instants — the TTFT decomposition SERVING.md documents
            spans.record("queue_wait", (t_pre - req.submit_ts) * 1e3,
                         parent="serve_request", rid=req.rid)
            spans.record("prefill", (now - t_pre) * 1e3,
                         parent="serve_request", rid=req.rid,
                         bucket=info["bucket"])
            if req.prefix_len > 0:
                # prefix-cache hit: a serve_suffix child over the SAME
                # interval as prefill (parent="prefill", not a sibling
                # under serve_request), so queue_wait + prefill == ttft
                # stays exact while the trace shows which admissions ran
                # the suffix-only path
                spans.record("serve_suffix", (now - t_pre) * 1e3,
                             parent="prefill", rid=req.rid,
                             prefix_len=req.prefix_len,
                             bucket=info["bucket"])
            req.tokens.append(tok)
            req.slot = slot
            ADMITTED.inc()
            TOKENS.inc()
            TTFT.observe(req.ttft_s)
            if self.slo is not None:
                # the measured TTFT/queue-wait of every admission IS
                # the control signal — no separate sampling path
                self.slo.observe_queue_wait(t_pre - req.submit_ts)
                self.slo.observe_ttft(req.ttft_s)
            journal.emit("serve_admit", rid=req.rid, slot=slot,
                         prompt_len=n, bucket=info["bucket"],
                         prefix_len=req.prefix_len)
            if req.done:          # max_new_tokens == 1 (or instant eos)
                self._complete(req, completed)
            else:
                self.slots[slot] = req

    def step(self) -> List[Request]:
        """One scheduler iteration; returns requests completed by it."""
        completed: List[Request] = []
        self._admit(completed)
        if self.active:
            toks = self.engine.decode()
            self.steps += 1
            self.live_slot_steps += self.active
            for slot, req in enumerate(self.slots):
                if req is None:
                    continue
                req.tokens.append(int(toks[slot]))
                TOKENS.inc()
                if req.done:
                    self.slots[slot] = None
                    self._complete(req, completed)
        OCCUPANCY.set(self.active)
        return completed

    def run_until_idle(self, max_steps: int = 1_000_000) -> List[Request]:
        completed: List[Request] = []
        for _ in range(max_steps):
            if self.idle:
                return completed
            completed.extend(self.step())
        raise RuntimeError("scheduler failed to drain in %d steps"
                           % max_steps)


def run_open_loop(batcher: ContinuousBatcher,
                  arrivals: Sequence[Tuple[float, Request]],
                  clock=time.perf_counter,
                  sleep=None) -> List[Request]:
    """Drive the batcher under an open-loop arrival process.

    `arrivals` is [(offset_seconds, request)]: each request is submitted
    once the wall clock passes its offset (independent of service rate —
    the open-loop property), the batcher steps whenever there is live
    work, and the call returns when everything has completed. TTFT and
    per-request latency are measured from each request's actual submit
    time, so queueing delay under load is included.

    With a fake clock (`slo.VirtualClock` or anything exposing
    `sleep()`), idle gaps advance the clock instead of the wall —
    no `time.sleep` in the hot loop, so overload benches and SLO tests
    replay an arrival schedule deterministically on CPU CI. Requests a
    bounded-queue batcher sheds at submit are returned too (their
    `outcome`/`error` name the shed) — an open-loop load generator must not
    crash because the system under test protected itself."""
    if sleep is None:
        sleep = getattr(clock, "sleep", time.sleep)
    pend = deque(sorted(arrivals, key=lambda p: p[0]))
    completed: List[Request] = []
    t0 = clock()
    while pend or not batcher.idle:
        now = clock() - t0
        while pend and pend[0][0] <= now:
            req = pend.popleft()[1]
            try:
                batcher.submit(req)
            except ShedError:
                completed.append(req)
        if batcher.idle and pend:
            delay = pend[0][0] - (clock() - t0)
            if delay > 0:
                sleep(delay)
            continue
        completed.extend(batcher.step())
    return completed
