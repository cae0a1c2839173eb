"""Health protocol: per-rank heartbeat files (the port's copy of
paddle_tpu/resilience/health.py).

A process that HANGS keeps its pid alive while it makes no progress. Each
worker's loop therefore writes a tiny heartbeat file

    <dir>/hb-rank<N>.json    {"pid": ..., "rank": ..., "step": ..., "ts": ...}

via write-to-temp + atomic rename, without fsync (a heartbeat only needs
to be fresh while the host is alive). The file's name and JSON are the
reference's, so the JAX launcher's hang detector, which compares the
file's mtime against `PADDLE_TPU_HANG_TIMEOUT_S`, reads a port process as
it reads its own; /healthz reads the same file (observability/httpd.py).

Tick sources (all rate-limited through one writer, default 1s):
  * the serving loop, every iteration (inference/serving/server.py);
  * `StepTelemetry._finish`: any finished engine dispatch is progress.

Workers configure themselves from the environment
(`PADDLE_TPU_HEARTBEAT_DIR` + `PADDLE_TRAINER_ID`); without it every hook
is a cheap no-op. Pure stdlib: ticking writes a file and makes no device
call.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

ENV_DIR = "PADDLE_TPU_HEARTBEAT_DIR"
ENV_INTERVAL = "PADDLE_TPU_HEARTBEAT_INTERVAL_S"
ENV_HANG_TIMEOUT = "PADDLE_TPU_HANG_TIMEOUT_S"

__all__ = ["ENV_DIR", "ENV_INTERVAL", "ENV_HANG_TIMEOUT", "HeartbeatWriter",
           "heartbeat_path", "read_heartbeat", "stale_seconds", "tick",
           "configure", "reset"]


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, "hb-rank%d.json" % int(rank))


def _observe_tick(rank: int, step: Optional[int]):
    """Best-effort metrics (module also loads standalone, without the
    package parent — same degradation contract as retry._observe_retry)."""
    try:
        from ..observability import metrics
    except Exception:
        return
    try:
        metrics.counter("pt_worker_heartbeat_ticks_total",
                        "Heartbeat files written by this worker").inc()
        if step is not None:
            metrics.gauge("pt_worker_heartbeat_step",
                          "Step recorded in the last heartbeat").set(step)
    except Exception:
        pass


def _observe_gap(rank: int, gap_s: float, step: Optional[int]):
    """A tick arriving long after the previous one means the step loop
    stalled and RECOVERED — invisible to the hang detector (which only
    sees ranks that never come back) but exactly what a post-mortem
    wants in the flight ring. Best-effort, standalone-safe."""
    try:
        from ..observability import flight
    except Exception:
        return
    try:
        flight.record("heartbeat_gap", rank=rank, gap_s=round(gap_s, 3),
                      step=step)
    except Exception:
        pass


class HeartbeatWriter:
    """Rate-limited atomic heartbeat file writer for ONE rank.

        hb = HeartbeatWriter("/logs", rank=1)
        hb.tick(step)            # no-op if the last write was < interval ago
        hb.tick(step, force=True)
    """

    def __init__(self, directory: str, rank: int,
                 min_interval_s: Optional[float] = None):
        self.directory = directory
        self.rank = int(rank)
        if min_interval_s is None:
            try:
                min_interval_s = float(os.environ.get(ENV_INTERVAL, "1.0"))
            except ValueError:
                min_interval_s = 1.0
        self.min_interval_s = max(0.0, float(min_interval_s))
        self.path = heartbeat_path(directory, self.rank)
        self.last_step: Optional[int] = None
        self.ticks_written = 0
        self._last_write = 0.0

    def tick(self, step: Optional[int] = None, force: bool = False) -> bool:
        """Record progress; returns whether a file write happened. Never
        raises — a full disk must not take down the step loop."""
        if step is not None:
            self.last_step = int(step)
        now = time.monotonic()
        if not force and now - self._last_write < self.min_interval_s \
                and self.ticks_written:
            return False
        rec = {"pid": os.getpid(), "rank": self.rank,
               "step": self.last_step, "ts": round(time.time(), 6)}
        tmp = "%s.tmp.%d" % (self.path, os.getpid())
        try:
            os.makedirs(self.directory, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        if self.ticks_written and self._last_write:
            gap = now - self._last_write
            if gap > max(5.0, 5 * self.min_interval_s):
                _observe_gap(self.rank, gap, self.last_step)
        self._last_write = now
        self.ticks_written += 1
        _observe_tick(self.rank, self.last_step)
        return True


def read_heartbeat(path: str) -> Optional[dict]:
    """Parse one heartbeat file; None when missing/corrupt (a torn rename
    or a crash mid-write must not crash the watch loop)."""
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


def stale_seconds(path: str, now: Optional[float] = None) -> Optional[float]:
    """Age of the heartbeat FILE (mtime — same host, same clock as the
    launcher); None when no heartbeat exists yet. A worker that wedges
    before its first tick is the bootstrap deadline's problem
    (PADDLE_TPU_BOOTSTRAP_DEADLINE_S), not the hang detector's."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    return (time.time() if now is None else now) - mtime


# --------------------------------------------------------------------------
# process-wide writer, configured from the launcher-exported env

_writer: Optional[HeartbeatWriter] = None
_configured_for: Optional[str] = None


def _env_writer() -> Optional[HeartbeatWriter]:
    global _writer, _configured_for
    directory = os.environ.get(ENV_DIR)
    if directory != _configured_for:
        _configured_for = directory
        if directory:
            try:
                rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
            except ValueError:
                rank = 0
            _writer = HeartbeatWriter(directory, rank)
        else:
            _writer = None
    return _writer


def configure(directory: Optional[str], rank: Optional[int] = None
              ) -> Optional[HeartbeatWriter]:
    """Programmatic setup (tests): equivalent to exporting the env vars."""
    if directory:
        os.environ[ENV_DIR] = directory
        if rank is not None:
            os.environ["PADDLE_TRAINER_ID"] = str(rank)
    else:
        os.environ.pop(ENV_DIR, None)
    return _env_writer()


def reset() -> None:
    configure(None)


def tick(step: Optional[int] = None, force: bool = False) -> bool:
    """Module-level tick through the env-configured writer; cheap no-op
    when PADDLE_TPU_HEARTBEAT_DIR is unset (standalone runs)."""
    w = _env_writer()
    return w.tick(step, force=force) if w is not None else False
