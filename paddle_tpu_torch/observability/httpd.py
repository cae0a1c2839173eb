"""Live telemetry plane: embedded /metrics /healthz /statusz /journal
(the port's copy of paddle_tpu/observability/httpd.py).

A stdlib-only threaded HTTP server a process can embed, serving

  * ``/metrics``   — Prometheus text exposition of the process registry;
  * ``/healthz``   — 200/503 from heartbeat staleness, watchdog fires,
                     and pluggable probes (the serving loop registers
                     its worker-thread liveness), so a router can drain
                     a sick replica;
  * ``/statusz``   — JSON snapshot: rank, trace id, retrace counts by
                     engine, serving queue depth / occupancy and
                     TTFT/latency p50/p95 estimated from the histograms,
                     the SLO block, device-memory gauges and the
                     executable bank, plus whatever status providers the
                     process registered;
  * ``/journal?n=K`` — the redacted tail of the active run journal.

The handlers read the metrics registry, the journal file and host-side
memory books only: they make no CUDA call, so a scrape cannot disturb a
graph capture on a serving worker.

OFF BY DEFAULT — with ``PADDLE_TPU_HTTP_PORT`` unset and no explicit
port, no socket is ever opened. Enable via the env var or
``InferenceServer(http_port=port)``. Port 0 binds an ephemeral port and
writes the bound address to ``endpoint-rank<N>.json`` in the telemetry
dir for discovery. Binds 127.0.0.1 by default — export
``PADDLE_TPU_HTTP_HOST`` to widen, behind an authenticating proxy.

The reference's launcher fleet mode (``fleet_status``: fan out to every
rank's endpoint and merge the answers) waits for the port's distributed
slice and is not here.
"""
from __future__ import annotations

import json
import math
import os
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from . import journal, metrics, spans

__all__ = [
    "ENV_PORT", "ENV_HOST", "ENV_STALE", "TelemetryServer",
    "ensure_server", "start_from_env", "active_server", "shutdown",
    "register_probe", "unregister_probe", "register_status",
    "unregister_status", "check_health", "build_status",
    "hist_quantile", "redact_line", "endpoint_path",
]

ENV_PORT = "PADDLE_TPU_HTTP_PORT"
ENV_HOST = "PADDLE_TPU_HTTP_HOST"
#: /healthz declares the heartbeat stale past this age (seconds)
ENV_STALE = "PADDLE_TPU_HEALTHZ_STALE_S"

_START_TS = time.time()

HTTP_REQUESTS = metrics.counter(
    "pt_http_requests_total",
    "Telemetry endpoint requests served", labelnames=("route", "code"))

# pluggable health probes / status providers; process-wide like the
# journal's set_journal — the serving loop registers itself
_plug_lock = threading.Lock()
_probes: Dict[str, Callable[[], Tuple[bool, str]]] = {}
_providers: Dict[str, Callable[[], dict]] = {}


def register_probe(name: str, fn: Callable[[], Tuple[bool, str]]) -> None:
    """Add a named /healthz check: fn() -> (ok, detail). Re-registering
    a name replaces it (a restarted InferenceServer supersedes the old
    one's probe)."""
    with _plug_lock:
        _probes[name] = fn


def unregister_probe(name: str) -> None:
    with _plug_lock:
        _probes.pop(name, None)


def register_status(name: str, fn: Callable[[], dict]) -> None:
    """Add a named /statusz block: fn() -> JSON-serializable dict."""
    with _plug_lock:
        _providers[name] = fn


def unregister_status(name: str) -> None:
    with _plug_lock:
        _providers.pop(name, None)


# ----------------------------------------------------------------- helpers
def _rank() -> int:
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    except ValueError:
        return 0


def endpoint_path(directory: str, rank: int) -> str:
    return os.path.join(directory, "endpoint-rank%d.json" % int(rank))


def _metric_series(name: str):
    """[(labels, child), ...] of a registered metric, else []."""
    m = metrics.REGISTRY.get(name)
    return list(m._series()) if m is not None else []


def _scalar(name: str) -> Optional[float]:
    """Sum of a counter/gauge's children, None when unregistered."""
    series = _metric_series(name)
    vals = [c.value for _, c in series if hasattr(c, "value")]
    return sum(vals) if vals else None


def _by_label(name: str, label: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for lbls, child in _metric_series(name):
        key = lbls.get(label)
        if key is not None and hasattr(child, "value"):
            out[key] = out.get(key, 0.0) + child.value
    return out


def _merged_hist(name: str):
    """(cumulative [(le, cum)], count, sum) merged across a histogram's
    label children (same bucket edges by construction), or None."""
    series = _metric_series(name)
    merged: Dict[float, int] = {}
    count, total = 0, 0.0
    seen = False
    for _, child in series:
        if not hasattr(child, "cumulative"):
            continue
        seen = True
        count += child.count
        total += child.sum
        for le, cum in child.cumulative():
            merged[le] = merged.get(le, 0) + cum
    if not seen:
        return None
    cum = sorted(merged.items(), key=lambda kv: kv[0])
    return cum, count, total


def hist_quantile(cumulative, q: float) -> Optional[float]:
    """Prometheus-style quantile estimate from cumulative bucket counts
    ([(le, cum_count), ...], q in [0,1]): linear interpolation inside
    the bucket holding the target rank; the +Inf bucket degrades to its
    lower edge (no upper bound to interpolate toward)."""
    if not cumulative:
        return None
    total = cumulative[-1][1]
    if total <= 0:
        return None
    target = q * total
    prev_le, prev_cum = 0.0, 0
    for le, cum in cumulative:
        if cum >= target:
            if le == math.inf:
                return prev_le
            if cum == prev_cum:
                return le
            frac = (target - prev_cum) / float(cum - prev_cum)
            return prev_le + frac * (le - prev_le)
        prev_le, prev_cum = le, cum
    return prev_le


def _hist_block(name: str, scale: float = 1.0) -> Optional[dict]:
    """{count, mean, p50, p95} of a histogram (values * scale), or None
    when the metric is unregistered or empty."""
    merged = _merged_hist(name)
    if merged is None:
        return None
    cum, count, total = merged
    if not count:
        return None
    out = {"count": count, "mean": round(scale * total / count, 6)}
    for q, key in ((0.5, "p50"), (0.95, "p95")):
        est = hist_quantile(cum, q)
        if est is not None:
            out[key] = round(scale * est, 6)
    return out


# ----------------------------------------------------------------- healthz
def _heartbeat_probe() -> Tuple[bool, str]:
    """Stale own-rank heartbeat file == the step/serve loop stopped
    ticking. Only armed when the launcher (or a test) exported
    PADDLE_TPU_HEARTBEAT_DIR; a missing file is healthy (bootstrap is
    the bootstrap deadline's problem, same rule as the hang detector)."""
    from ..resilience import health
    directory = os.environ.get(health.ENV_DIR)
    if not directory:
        return True, "heartbeat not configured"
    try:
        threshold = float(os.environ.get(ENV_STALE, "") or 60.0)
    except ValueError:
        threshold = 60.0
    stale = health.stale_seconds(health.heartbeat_path(directory, _rank()))
    if stale is None:
        return True, "no heartbeat yet"
    if stale > threshold:
        return False, "heartbeat stale %.1fs > %.1fs" % (stale, threshold)
    return True, "heartbeat %.1fs old" % stale


def _watchdog_probe() -> Tuple[bool, str]:
    fires = _scalar("pt_watchdog_fires_total") or 0
    if fires:
        return False, "watchdog fired %d time(s)" % int(fires)
    return True, "watchdog quiet"


def check_health() -> dict:
    """Evaluate every probe; {"ok": bool, "checks": {name: {...}}}. A
    probe that raises counts as failed (a broken check must read as
    sick, not healthy)."""
    with _plug_lock:
        plugged = list(_probes.items())
    checks = {}
    ok = True
    for name, fn in [("heartbeat", _heartbeat_probe),
                     ("watchdog", _watchdog_probe)] + plugged:
        try:
            good, detail = fn()
        except Exception as e:
            good, detail = False, "probe error: %s" % e
        checks[name] = {"ok": bool(good), "detail": detail}
        ok = ok and bool(good)
    return {"ok": ok, "checks": checks}


# ----------------------------------------------------------------- statusz
def build_status() -> dict:
    now = time.time()
    st: dict = {"ts": round(now, 3), "rank": _rank(), "pid": os.getpid(),
                "host": socket.gethostname(), "trace": spans.trace_id(),
                "uptime_s": round(now - _START_TS, 3)}
    train: dict = {}
    steps = _scalar("pt_train_steps_total")
    if steps is not None:
        train["steps_total"] = int(steps)
    hb_step = _scalar("pt_worker_heartbeat_step")
    if hb_step is not None:
        train["heartbeat_step"] = int(hb_step)
    interval = _merged_hist("pt_step_interval_seconds")
    if interval is not None and interval[2] > 0:
        train["step_rate_per_s"] = round(interval[1] / interval[2], 4)
    retraces = _by_label("pt_jit_retraces_total", "engine")
    if retraces:
        train["retraces"] = {k: int(v) for k, v in sorted(retraces.items())}
    if train:
        st["train"] = train
    serving: dict = {}
    for key, name in (("queue_depth", "pt_serve_queue_depth"),
                      ("batch_occupancy", "pt_serve_batch_occupancy"),
                      ("admitted", "pt_serve_admitted_total"),
                      ("completed", "pt_serve_completed_total"),
                      ("tokens", "pt_serve_tokens_total"),
                      ("prefix_cache_hits", "pt_prefix_cache_hits_total"),
                      ("prefix_cache_misses",
                       "pt_prefix_cache_misses_total"),
                      ("prefix_cache_evictions",
                       "pt_prefix_cache_evictions_total"),
                      ("prefix_cache_bytes", "pt_prefix_cache_bytes")):
        v = _scalar(name)
        if v is not None:
            serving[key] = int(v) if float(v).is_integer() else v
    ttft = _hist_block("pt_serve_ttft_seconds", scale=1e3)
    if ttft:
        serving["ttft_ms"] = ttft
    latency = _hist_block("pt_serve_request_seconds", scale=1e3)
    if latency:
        serving["latency_ms"] = latency
    if serving:
        st["serving"] = serving
    # SLO control plane (serving/slo.py): present only once an
    # AdmissionController exists in-process — the budget gauge is its
    # registration mark, so a policy-free build keeps /statusz
    # byte-identical
    budget = _scalar("pt_slo_ttft_budget_ms")
    if budget:
        slo: dict = {"ttft_budget_ms": budget}
        state = _scalar("pt_admission_state") or 0
        slo["state"] = {0: "healthy", 1: "shedding",
                        2: "brownout"}.get(int(state), "?")
        p99 = _scalar("pt_slo_ttft_p99_ms")
        if p99 is not None:
            slo["ttft_p99_ms"] = round(p99, 3)
        shed_by_reason = _by_label("pt_serve_shed_total", "reason")
        shed_total = sum(shed_by_reason.values())
        slo["shed_total"] = int(shed_total)
        if shed_by_reason:
            slo["shed_by_reason"] = {
                k: int(v) for k, v in sorted(shed_by_reason.items())}
        admitted = _scalar("pt_serve_admitted_total") or 0
        seen = admitted + shed_total
        slo["shed_rate"] = round(shed_total / seen, 4) if seen else 0.0
        expired = _scalar("pt_serve_deadline_expired_total")
        if expired:
            slo["deadline_expired"] = int(expired)
        limit = _scalar("pt_slo_max_queue_depth")
        depth = _scalar("pt_serve_queue_depth")
        if limit:
            slo["max_queue_depth"] = int(limit)
            slo["queue_headroom"] = max(0, int(limit) - int(depth or 0))
        st["slo"] = slo
    hbm: dict = {}
    for key, name in (("in_use", "pt_hbm_bytes_in_use"),
                      ("peak", "pt_hbm_peak_bytes")):
        v = _scalar(name)
        if v is not None:
            hbm[key] = int(v)
    for key, name in (("args", "pt_hbm_args_bytes"),
                      ("temp", "pt_hbm_temp_bytes")):
        per_engine = _by_label(name, "engine")
        if per_engine:
            hbm[key] = {k: int(v) for k, v in sorted(per_engine.items())}
    try:
        from . import memprof
        bank = memprof.executable_bank()
        if bank:
            hbm["executables"] = bank
    except Exception:
        pass
    if hbm:
        st["hbm_bytes"] = hbm
    with _plug_lock:
        providers = list(_providers.items())
    for name, fn in providers:
        try:
            st[name] = fn()
        except Exception as e:
            st[name] = {"error": str(e)}
    return st


# ----------------------------------------------------------------- journal
_SECRET = re.compile(
    r'(?i)("(?:[^"]*(?:token|secret|passw|credential|authorization|'
    r'api_?key|access_key|private|bearer|cookie)[^"]*)"\s*:\s*)'
    r'("(?:[^"\\]|\\.)*"|[^,}\]\s]+)')


def redact_line(line: str) -> str:
    """Mask the value of any secret-looking key in a journal JSON line
    before it leaves the process over HTTP."""
    return _SECRET.sub(lambda m: m.group(1) + '"[REDACTED]"', line)


def _journal_tail(n: int) -> Tuple[Optional[str], str]:
    """(path, last-n redacted lines) of the active journal, else the
    rank's journal file in PADDLE_TPU_TELEMETRY_DIR."""
    j = journal.get_journal()
    path = j.path if j is not None else None
    if path is None:
        directory = os.environ.get("PADDLE_TPU_TELEMETRY_DIR")
        if directory:
            cand = os.path.join(directory,
                                "journal-rank%d.jsonl" % _rank())
            if os.path.exists(cand):
                path = cand
    if path is None or not os.path.exists(path):
        return None, ""
    try:
        with open(path, errors="replace") as f:
            lines = f.readlines()
    except OSError:
        return path, ""
    tail = [redact_line(ln.rstrip("\n")) for ln in lines[-n:] if ln.strip()]
    return path, "\n".join(tail) + ("\n" if tail else "")


# ------------------------------------------------------------------ server
class _Handler(BaseHTTPRequestHandler):
    """The route table."""

    server_version = "paddle-tpu-torch-telemetry"

    def log_message(self, fmt, *args):   # stderr is the run's, not ours
        pass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        parsed = urlparse(self.path)
        route = parsed.path.rstrip("/") or "/"
        code, body, ctype = 404, "not found: %s\n" % route, "text/plain"
        try:
            if route == "/metrics":
                code = 200
                body = metrics.REGISTRY.to_prometheus()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif route == "/healthz":
                health = check_health()
                code = 200 if health["ok"] else 503
                body = json.dumps(health, indent=1) + "\n"
                ctype = "application/json"
            elif route == "/statusz":
                status = build_status()
                code, ctype = 200, "application/json"
                body = json.dumps(status, indent=1, default=str) + "\n"
            elif route == "/journal":
                try:
                    n = int(parse_qs(parsed.query).get("n", ["100"])[0])
                except (ValueError, IndexError):
                    n = 100
                path, tail = _journal_tail(max(1, min(n, 10000)))
                if path is None:
                    code, body = 404, "no active journal\n"
                else:
                    code, body, ctype = 200, tail, "application/jsonl"
            elif route == "/":
                code, ctype = 200, "text/plain"
                body = ("paddle_tpu_torch telemetry: /metrics /healthz "
                        "/statusz /journal?n=K\n")
        except Exception as e:   # a broken endpoint must not kill serving
            code, body, ctype = 500, "internal error: %s\n" % e, "text/plain"
        try:
            HTTP_REQUESTS.labels(route, str(code)).inc()
        except Exception:
            pass
        self._send(code, body, ctype)


class TelemetryServer:
    """Threaded HTTP server wrapping the process registry/journal.

        srv = TelemetryServer(port=0, endpoint_dir="/logs").start()
        ... srv.url, srv.port ...
        srv.stop()

    `port=0` binds an ephemeral port and (when `endpoint_dir` resolves)
    writes `endpoint-rank<N>.json` for discovery."""

    def __init__(self, port: int = 0, host: Optional[str] = None,
                 rank: Optional[int] = None,
                 endpoint_dir: Optional[str] = None):
        self.rank = _rank() if rank is None else int(rank)
        self.host = host or os.environ.get(ENV_HOST) or "127.0.0.1"
        self.endpoint_dir = endpoint_dir \
            or os.environ.get("PADDLE_TPU_TELEMETRY_DIR") \
            or os.environ.get("PADDLE_TPU_HEARTBEAT_DIR")
        self._want_port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        self.endpoint_file: Optional[str] = None

    @property
    def url(self) -> Optional[str]:
        return "http://%s:%d" % (self.host, self.port) \
            if self.port is not None else None

    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        self._httpd = ThreadingHTTPServer((self.host, self._want_port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="pt-telemetry-http", daemon=True)
        self._thread.start()
        self._write_endpoint()
        journal.emit("http_listen", url=self.url, rank=self.rank)
        return self

    def _write_endpoint(self) -> None:
        """Atomic discovery-file write; best-effort (an unwritable dir
        must not take down the process the server observes)."""
        if not self.endpoint_dir:
            return
        path = endpoint_path(self.endpoint_dir, self.rank)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        try:
            os.makedirs(self.endpoint_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump({"rank": self.rank, "pid": os.getpid(),
                           "host": self.host, "port": self.port,
                           "url": self.url, "ts": round(time.time(), 3)},
                          f, indent=1)
            os.replace(tmp, path)
            self.endpoint_file = path
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        if self.endpoint_file:
            try:
                os.unlink(self.endpoint_file)
            except OSError:
                pass
            self.endpoint_file = None

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# process-wide singleton: every component shares one plane, and with the
# knob unset nothing below ever opens a socket
_server: Optional[TelemetryServer] = None
_server_lock = threading.Lock()


def active_server() -> Optional[TelemetryServer]:
    return _server


def ensure_server(port=None, host: Optional[str] = None,
                  rank: Optional[int] = None,
                  endpoint_dir: Optional[str] = None
                  ) -> Optional[TelemetryServer]:
    """Start (or return) the process's telemetry server. `port=None`
    defers to PADDLE_TPU_HTTP_PORT; unset/empty means DISABLED and
    returns None without touching a socket. Never raises — a malformed
    port must not take down the run it would have observed."""
    global _server
    with _server_lock:
        if _server is not None:
            return _server
        if port is None:
            port = os.environ.get(ENV_PORT)
        if port is None or str(port).strip() == "":
            return None
        try:
            srv = TelemetryServer(port=int(port), host=host, rank=rank,
                                  endpoint_dir=endpoint_dir)
            srv.start()
        except (ValueError, OSError) as e:
            journal.emit("http_listen_failed", error=str(e), port=str(port))
            return None
        _server = srv
        return srv


def start_from_env(endpoint_dir: Optional[str] = None
                   ) -> Optional[TelemetryServer]:
    """Env-only entry point: a socket is opened iff
    PADDLE_TPU_HTTP_PORT is set."""
    return ensure_server(endpoint_dir=endpoint_dir)


def shutdown() -> None:
    """Stop the process-wide server (tests / clean teardown)."""
    global _server
    with _server_lock:
        srv, _server = _server, None
    if srv is not None:
        srv.stop()
