"""Telemetry on the port (stdlib copies of the reference's observability
modules, with memory read from the CUDA caching allocator):

  * `metrics`  — Counter/Gauge/Histogram registry with Prometheus-text and
                 JSON exporters (`REGISTRY`);
  * `journal`  — append-only JSONL run journal, mirrored into the flight
                 ring;
  * `spans`    — wall-time spans of serving requests;
  * `tracing`  — `StepTelemetry` program-build/step-latency accounting,
                 gated by `PADDLE_TPU_TELEMETRY` / `tracing.enable()`;
  * `flight`   — bounded ring of recent events + device-memory gauges,
                 dumped as a crash bundle;
  * `memprof`  — device-memory sampler, executable bank and OOM
                 post-mortem on CUDA;
  * `httpd`    — the live /metrics /healthz /statusz /journal plane, off
                 unless `PADDLE_TPU_HTTP_PORT` (or a port) asks for it.
"""
from . import flight, httpd, journal, memprof, metrics, spans, tracing

__all__ = ["flight", "httpd", "journal", "memprof", "metrics", "spans",
           "tracing"]
