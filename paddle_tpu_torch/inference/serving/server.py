"""Multi-worker serving front end over the generation engine (the port's
counterpart of paddle_tpu/inference/serving/server.py).

A thread-per-worker serving loop fed by one shared request queue. Each
worker owns a GenerationEngine (its own paged KV cache, slots, prefix
cache and step programs: on CUDA one graph pool a worker) but all workers
share the SAME model, whose weights the programs read in place, so N
workers cost one copy of the weights plus N caches and N pools. Every
dispatch and capture of every engine runs under the engine module's one
`_DISPATCH_LOCK`, so workers overlap only their host work.

Every loop iteration calls `resilience.health.tick()` (the heartbeat a
hang detector and /healthz read), a crashed loop dumps a flight-recorder
crash bundle before failing its in-flight requests, and queue depth is
exported as `pt_serve_queue_depth`. With `http_port` (or
PADDLE_TPU_HTTP_PORT) set, the live plane serves /metrics, /healthz (the
`serve_loop` probe: 200 while degraded, 503 on a dead worker) and
/statusz (with a `serving_workers` block).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Sequence

from ...observability import flight, httpd, metrics, spans
from ...resilience import health
from .engine import GenerationEngine
from .scheduler import ContinuousBatcher, Request
from .slo import AdmissionController, ShedError, SLOPolicy

__all__ = ["InferenceServer", "ServeHandle"]

QUEUE_DEPTH = metrics.gauge(
    "pt_serve_queue_depth",
    "Requests waiting in the server queue (not yet in a decode slot)")


class ServeHandle:
    """Future-like handle on a submitted request."""

    def __init__(self, request: Request):
        self.request = request
        self._event = threading.Event()
        self._error: Optional[BaseException] = None

    def _finish(self, error: Optional[BaseException] = None) -> None:
        self._error = error
        self._event.set()

    def _completed(self, req) -> None:
        # admission control answers through the same callback: a queued
        # request whose deadline expired carries its ShedError
        self._finish(getattr(req, "error", None))

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block for the generated tokens. Raises ShedError (with
        `retry_after_s`) when admission control rejected the request —
        the replica is degraded but alive, retry later — and
        RuntimeError when the serving loop actually failed."""
        if not self._event.wait(timeout):
            raise TimeoutError("request %d not complete within %ss"
                               % (self.request.rid, timeout))
        if isinstance(self._error, ShedError):
            raise self._error
        if self._error is not None:
            raise RuntimeError(
                "serving loop failed while handling request %d"
                % self.request.rid) from self._error
        return list(self.request.tokens)


class InferenceServer:
    """Threaded continuous-batching server.

        with InferenceServer(model, max_batch=4) as srv:
            h = srv.submit([1, 2, 3], max_new_tokens=8)
            tokens = h.result(timeout=60)

    The engines run on `device` ("cuda" unless the caller asks for the
    CPU; without CUDA it raises), where the model must already lie.
    """

    def __init__(self, model, max_batch: int = 4, max_seq_len: int = 128,
                 prefill_buckets: Sequence[int] = (32, 64, 128),
                 pad_id: int = 0, workers: int = 1,
                 poll_s: float = 0.002, http_port=None,
                 kv_dtype: str = "float32", prefix_cache_bytes=None,
                 slo=None, device="cuda"):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        # SLO admission control: explicit SLOPolicy/AdmissionController,
        # or PADDLE_TPU_SLO_TTFT_MS from the environment; absent both,
        # None — submit/step behavior identical to a policy-free build.
        # ONE controller is shared across all workers so the live p99
        # and the admission state reflect the whole replica.
        if slo is None:
            slo = SLOPolicy.from_env()
        if isinstance(slo, SLOPolicy):
            slo = AdmissionController(slo)
        self._slo: Optional[AdmissionController] = slo
        # each worker gets its OWN prefix cache (an engine copies a stored
        # prefix into its own buffers); kv_dtype="int8" cuts each
        # worker's cache to about a quarter
        self._engines = [
            GenerationEngine(model, max_batch=max_batch,
                             max_seq_len=max_seq_len,
                             prefill_buckets=prefill_buckets, pad_id=pad_id,
                             kv_dtype=kv_dtype,
                             prefix_cache_bytes=prefix_cache_bytes,
                             device=device)
            for _ in range(workers)]
        self._queue: "queue.Queue[ServeHandle]" = queue.Queue()
        self._poll_s = poll_s
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._started = False
        # live telemetry plane: socket opened ONLY when http_port or
        # $PADDLE_TPU_HTTP_PORT asks for one
        self._http_port = http_port
        self._http = None

    @property
    def engines(self) -> List[GenerationEngine]:
        return list(self._engines)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "InferenceServer":
        if self._started:
            return self
        self._started = True
        for i, eng in enumerate(self._engines):
            t = threading.Thread(target=self._loop, args=(eng,),
                                 name="pt-serve-%d" % i, daemon=True)
            t.start()
            self._threads.append(t)
        try:
            self._http = httpd.ensure_server(port=self._http_port)
        except Exception:
            self._http = None
        if self._http is not None:
            # a dead batcher loop must flip /healthz to 503 so a router
            # drains this replica instead of timing requests out
            httpd.register_probe("serve_loop", self._loop_alive)
            httpd.register_status("serving_workers", self._http_status)
        return self

    def _loop_alive(self):
        """/healthz probe: every worker thread of a started, not-yet-
        stopped server must be alive (a crashed loop leaves a dead
        thread behind — the raise in _loop ends it)."""
        dead = [t.name for t in self._threads if not t.is_alive()]
        if self._started and not self._stop.is_set() and dead:
            return False, "dead serving worker(s): %s" % ",".join(dead)
        detail = "%d/%d workers alive" % (
            sum(t.is_alive() for t in self._threads), len(self._threads))
        if self._slo is not None and self._slo.state != "healthy":
            # degraded-but-alive: shedding load is the replica WORKING,
            # not dying — stay 200 (a 503 here would make the router
            # drain exactly the replica that is protecting itself);
            # the detail names the brownout so operators see it
            detail += "; admission=%s (degraded, shedding load)" \
                % self._slo.state
        return True, detail

    def _http_status(self) -> dict:
        st = {"workers": len(self._threads),
              "alive": sum(t.is_alive() for t in self._threads),
              "queue_depth": self._queue.qsize(),
              "stopping": self._stop.is_set()}
        if self._slo is not None:
            st["degraded"] = self._slo.state != "healthy"
        return st

    def stop(self, timeout: float = 60.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        if self._http is not None:
            # a cleanly-stopped server is not a sick one
            httpd.unregister_probe("serve_loop")
            httpd.unregister_status("serving_workers")
            self._http = None

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    # -- request path -----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> ServeHandle:
        if not self._started:
            raise RuntimeError("server not started (use start() or `with`)")
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      eos_id=eos_id, submit_ts=time.perf_counter())
        # root span begins on the SUBMITTER's thread (same instant as
        # submit_ts) and ends in the worker loop at _complete — the
        # begin/end cross-thread form exists for exactly this hand-off
        req.span = spans.begin("serve_request", rid=req.rid)
        handle = ServeHandle(req)
        req.on_complete = handle._completed
        self._queue.put(handle)
        QUEUE_DEPTH.set(self._queue.qsize())
        return handle

    def _drain_into(self, batcher: ContinuousBatcher) -> None:
        while True:
            try:
                handle = self._queue.get_nowait()
            except queue.Empty:
                break
            self._submit_or_fail(batcher, handle)
        QUEUE_DEPTH.set(self._queue.qsize())

    @staticmethod
    def _submit_or_fail(batcher: ContinuousBatcher,
                        handle: ServeHandle) -> None:
        try:
            batcher.submit(handle.request)
        except Exception as exc:   # invalid request must not kill the loop
            handle._finish(exc)

    def _loop(self, engine: GenerationEngine) -> None:
        batcher = ContinuousBatcher(engine, slo=self._slo)
        try:
            while True:
                self._drain_into(batcher)
                if batcher.idle:
                    if self._stop.is_set():
                        return
                    try:
                        handle = self._queue.get(timeout=self._poll_s)
                    except queue.Empty:
                        continue
                    self._submit_or_fail(batcher, handle)
                    continue
                batcher.step()
                health.tick()
        except BaseException as exc:
            flight.dump_crash_bundle("serve_loop", exc)
            self._fail_pending(batcher, exc)
            raise

    @staticmethod
    def _fail_pending(batcher: ContinuousBatcher,
                      exc: BaseException) -> None:
        # fail every handle this worker still owed an answer to; the
        # completion callback is a bound ServeHandle method, so the
        # handle is reachable from the request itself
        for req in batcher.pending_requests():
            handle = getattr(req.on_complete, "__self__", None)
            if isinstance(handle, ServeHandle):
                handle._finish(exc)
