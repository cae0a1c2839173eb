"""Flight recorder: bounded event ring + device-memory gauges + crash
bundles (the port's copy of paddle_tpu/observability/flight.py).

A bounded in-memory ring of the most recent structured events: step and
program-build ends (StepTelemetry), every journal record (the journal's
tap), dispatch notes and memory samples, fed at near-zero cost, plus
device-memory gauges sampled from the caching allocator's counters
(memprof.read_device_memory). On a crash, a dead serving loop, an OOM,
an unhandled exception (or SIGTERM, behind an opt-in knob) the ring is
dumped as a **crash bundle**, laid out as the reference's:

    <dir>/crash/<rank>-<ts>/
        MANIFEST.json   reason, rank, pid, last dispatch/compile/step
        ring.jsonl      the ring contents, oldest first
        metrics.json    registry snapshot at death
        stacks.txt      all-thread Python stacks (faulthandler)
        env.json        env/config fingerprint (PADDLE/CUDA/TORCH/... keys)
        memory.json     live allocations, executable bank, memory history

Env knobs, the reference's:

    PADDLE_TPU_FLIGHT_DIR           bundle root (defaults to
                                    PADDLE_TPU_TELEMETRY_DIR); unset +
                                    unconfigured = dumps are no-ops
    PADDLE_TPU_FLIGHT_EVENTS        ring capacity (default 512)
    PADDLE_TPU_HBM_SAMPLE_S         min seconds between memory samples
                                    (default 0.5; first call always
                                    samples)
    PADDLE_TPU_FLIGHT_DUMP_ON_TERM  "1": also dump on SIGTERM, and on a
                                    preemption a PreemptionGuard caught
                                    (`on_preemption`; off by default)

Nothing here calls the CUDA runtime: the memory reads are the
allocator's host-side books, so a sample or a bundle written from one
thread cannot disturb a graph capture on another. Every public function
is best-effort: observing a run must never be what kills it.
"""
from __future__ import annotations

import collections
import faulthandler
import json
import os
import platform as _platform
import signal
import socket
import sys
import threading
import time
import traceback
from typing import Optional

from . import memprof, metrics

__all__ = ["record", "record_raw", "note_compile", "note_dispatch",
           "step_finished", "sample_hbm", "configure",
           "dump_crash_bundle", "on_preemption", "ring_events", "reset"]

ENV_DIR = "PADDLE_TPU_FLIGHT_DIR"
ENV_EVENTS = "PADDLE_TPU_FLIGHT_EVENTS"
ENV_HBM_INTERVAL = "PADDLE_TPU_HBM_SAMPLE_S"
ENV_DUMP_ON_TERM = "PADDLE_TPU_FLIGHT_DUMP_ON_TERM"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


_ring = collections.deque(maxlen=max(16, _env_int(ENV_EVENTS, 512)))
_dir: Optional[str] = None
_rank: Optional[int] = None
_last_compile: Optional[dict] = None
_last_dispatch: Optional[dict] = None
_last_step: Optional[int] = None
_dump_lock = threading.Lock()
_dumped_path: Optional[str] = None
_hooks_installed = False
_prev_excepthook = None

_hbm_last_sample = 0.0
_hbm_peak = 0.0
_g_in_use = _g_peak = None


# ------------------------------------------------------------------ ring
def record(event: str, **fields) -> None:
    """Append one event to the ring (deque append is atomic in CPython;
    no lock on the hot path). Never raises."""
    try:
        rec = {"ts": round(time.time(), 6), "event": event}
        rec.update(fields)
        _ring.append(rec)
    except Exception:
        pass


def record_raw(rec: dict) -> None:
    """Journal tap: the record already carries the journal envelope."""
    try:
        _ring.append(rec)
    except Exception:
        pass


def ring_events() -> list:
    """Snapshot of the ring, oldest first."""
    return list(_ring)


def note_compile(engine: str, signature) -> None:
    """StepTelemetry miss: remember which program was last built — the
    bundle's answer to 'what was being built (captured) when it died'."""
    global _last_compile
    try:
        _last_compile = {"ts": round(time.time(), 6), "engine": engine,
                         "signature": repr(signature)[:2000]}
        _ring.append(dict(_last_compile, event="compile_begin"))
    except Exception:
        pass


def note_dispatch(engine: str, step: Optional[int] = None) -> None:
    """Engine hook, per dispatch: what is in flight right now."""
    global _last_dispatch, _last_step
    _last_dispatch = {"engine": engine, "step": step,
                      "ts": round(time.time(), 6)}
    if step is not None:
        _last_step = step


def step_finished(engine: str, dt: float, miss: bool = False) -> None:
    """StepTelemetry finish tap: ring the step/compile end and (rate-
    limited) sample HBM. One dict + one append per step."""
    try:
        _ring.append({"ts": round(time.time(), 6),
                      "event": "compile_end" if miss else "step_end",
                      "engine": engine, "dt": round(dt, 6)})
        sample_hbm(phase="dispatch")
    except Exception:
        pass


# ------------------------------------------------------------- HBM gauges
def sample_hbm(force: bool = False, phase: Optional[str] = None
               ) -> Optional[int]:
    """Sample device memory into pt_hbm_bytes_in_use / pt_hbm_peak_bytes.

    The read itself is memprof.read_device_memory(), the one sampler (the
    caching allocator's counters; None on the CPU, and then nothing is
    recorded). Rate-limited (PADDLE_TPU_HBM_SAMPLE_S, default 0.5s); the
    first call always samples. Each real sample also lands in the flight
    ring (`hbm` event) and memprof's phase-tagged history, so a crash
    bundle carries the recent memory timeline."""
    global _hbm_last_sample, _hbm_peak, _g_in_use, _g_peak
    now = time.monotonic()
    if not force and _hbm_last_sample and \
            now - _hbm_last_sample < _env_float(ENV_HBM_INTERVAL, 0.5):
        return None
    res = memprof.read_device_memory()
    if res is None:
        return None
    _hbm_last_sample = now
    try:
        in_use, peak = res
        _hbm_peak = max(_hbm_peak, float(in_use))
        if peak is None:
            peak = _hbm_peak
        if _g_in_use is None:
            _g_in_use = metrics.gauge(
                "pt_hbm_bytes_in_use",
                "Device memory in use at the last flight sample")
            _g_peak = metrics.gauge(
                "pt_hbm_peak_bytes",
                "Peak device memory (the allocator's peak bytes "
                "allocated)")
        _g_in_use.set(in_use)
        _g_peak.set(float(peak))
        memprof.note_sample(in_use, peak, phase=phase)
        _ring.append({"ts": round(time.time(), 6), "event": "hbm",
                      "in_use": int(in_use), "peak": int(peak),
                      "phase": phase})
        return in_use
    except Exception:
        return None


# --------------------------------------------------------------- configure
def _resolve_dir() -> Optional[str]:
    return _dir or os.environ.get(ENV_DIR) \
        or os.environ.get("PADDLE_TPU_TELEMETRY_DIR")


def _resolve_rank() -> int:
    if _rank is not None:
        return _rank
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    except ValueError:
        return 0


def configure(directory: Optional[str], rank: Optional[int] = None) -> None:
    """Set the bundle root (and rank) and install the process hooks:
    a chaining sys.excepthook that dumps before the crash unwinds, and —
    only with PADDLE_TPU_FLIGHT_DUMP_ON_TERM=1 — a SIGTERM dumper.
    Idempotent. Signal handlers are installed only from the main thread:
    a server may be started from any thread."""
    global _dir, _rank
    if directory:
        _dir = directory
    if rank is not None:
        try:
            _rank = int(rank)
        except (TypeError, ValueError):
            pass
    _install_hooks()


def _install_hooks() -> None:
    global _hooks_installed, _prev_excepthook
    if _hooks_installed:
        return
    _hooks_installed = True
    _prev_excepthook = sys.excepthook

    def _hook(tp, val, tb):
        dump_crash_bundle("exception", exc=val)
        if callable(_prev_excepthook):
            _prev_excepthook(tp, val, tb)

    try:
        sys.excepthook = _hook
    except Exception:
        pass
    if os.environ.get(ENV_DUMP_ON_TERM) != "1":
        return
    # opt-in only: a teardown SIGTERMs HEALTHY processes; dumping for
    # those would fake crash evidence. Installs only when the slot still
    # holds the default handler, and only from the main thread (signal
    # handlers can be set nowhere else).
    try:
        if threading.current_thread() is threading.main_thread() and \
                signal.getsignal(signal.SIGTERM) == signal.SIG_DFL:
            def _term(signum, frame):
                dump_crash_bundle("sigterm")
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            signal.signal(signal.SIGTERM, _term)
    except (ValueError, OSError):
        pass


# ------------------------------------------------------------ crash bundle
def _bundle_dir(base: str) -> str:
    stamp = time.strftime("%Y%m%dT%H%M%S")
    path = os.path.join(base, "crash", "%d-%s" % (_resolve_rank(), stamp))
    if os.path.exists(path):
        path += "-p%d" % os.getpid()
    return path


def _env_fingerprint() -> dict:
    prefixes = ("PADDLE", "CUDA", "TORCH", "NCCL", "FLAGS", "PT_")
    return {
        "python": sys.version,
        "platform": _platform.platform(),
        "argv": list(sys.argv),
        "cwd": os.getcwd(),
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith(prefixes)},
    }


def dump_crash_bundle(reason: str, exc: Optional[BaseException] = None,
                      last_step: Optional[int] = None,
                      force: bool = False,
                      memory: Optional[dict] = None,
                      **info) -> Optional[str]:
    """Write the crash bundle; returns its path (None when no directory
    is configured). Once per process by default — a serving loop's dump
    followed by the excepthook firing on the same exception must not
    produce two bundles — `force=True` overrides. Never raises; each
    artifact is written independently so a failure in one (e.g. a
    metrics snapshot racing a writer) cannot void the others. The
    `crash_bundle` journal line is emitted BEFORE returning: the
    journal flushes per line, so it survives an immediately following
    SIGKILL. `memory` (the memprof OOM payload: live-allocation table,
    executable analyses, memory history) is written as its own memory.json artifact; when it is
    not supplied but the executable bank or sample history has
    content, a best-effort memory.json is synthesized so every bundle
    answers "where were the bytes"."""
    global _dumped_path, _last_step
    base = _resolve_dir()
    if not base:
        return None
    with _dump_lock:
        if _dumped_path is not None and not force:
            return _dumped_path
        if last_step is not None:
            _last_step = last_step
        try:
            bdir = _bundle_dir(base)
            os.makedirs(bdir, exist_ok=True)
        except OSError:
            return None
        _dumped_path = bdir
    manifest = {"reason": reason, "ts": round(time.time(), 6),
                "iso": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "rank": _resolve_rank(), "pid": os.getpid(),
                "host": socket.gethostname(),
                "last_step": _last_step,
                "last_dispatch": _last_dispatch,
                "last_compile": _last_compile,
                "ring_events": len(_ring)}
    if exc is not None:
        manifest["error"] = "%s: %s" % (type(exc).__name__, exc)
    manifest.update(info)
    try:
        with open(os.path.join(bdir, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1, default=str)
    except Exception:
        pass
    try:
        with open(os.path.join(bdir, "ring.jsonl"), "w") as f:
            for rec in list(_ring):
                f.write(json.dumps(rec, default=str) + "\n")
    except Exception:
        pass
    try:
        with open(os.path.join(bdir, "stacks.txt"), "w") as f:
            if exc is not None:
                f.write("".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__)))
                f.write("\n--- all threads ---\n")
                # faulthandler writes to the raw fd; flush the buffered
                # text first or it lands on top of the dump
                f.flush()
            faulthandler.dump_traceback(file=f, all_threads=True)
    except Exception:
        pass
    try:
        metrics.REGISTRY.write_json(os.path.join(bdir, "metrics.json"))
    except Exception:
        pass
    try:
        with open(os.path.join(bdir, "env.json"), "w") as f:
            json.dump(_env_fingerprint(), f, indent=1, default=str)
    except Exception:
        pass
    try:
        if memory is None:
            bank = memprof.executable_bank()
            hist = memprof.hbm_history()
            if bank or hist:
                memory = {"reason": reason,
                          "device_kind": memprof.device_kind(),
                          "buffers": memprof.live_buffer_table(),
                          "executables": bank, "hbm_history": hist}
        if memory is not None:
            with open(os.path.join(bdir, "memory.json"), "w") as f:
                json.dump(memory, f, indent=1, default=str)
    except Exception:
        pass
    try:
        metrics.counter("pt_crash_bundles_total",
                        "Crash bundles dumped by the flight recorder").inc()
        from . import journal
        journal.emit("crash_bundle", reason=reason, path=bdir,
                     last_step=_last_step)
    except Exception:
        pass
    return bdir


def on_preemption(signum: int) -> None:
    """PreemptionGuard hook: a preemption is an orderly exit (the guard
    checkpoints and exits 0), so no bundle unless the operator opted in
    with PADDLE_TPU_FLIGHT_DUMP_ON_TERM=1. The ring gets the event through
    the journal's tap either way."""
    if os.environ.get(ENV_DUMP_ON_TERM) == "1":
        dump_crash_bundle("preemption", signum=int(signum))


def reset() -> None:
    """Test isolation: clear the ring, notes, dump once-guard and the
    configured directory; restore a hooked excepthook."""
    global _dir, _rank, _last_compile, _last_dispatch, _last_step
    global _dumped_path, _hooks_installed, _hbm_last_sample, _hbm_peak
    _ring.clear()
    _dir = _rank = None
    _last_compile = _last_dispatch = _last_step = None
    _dumped_path = None
    _hbm_last_sample = 0.0
    _hbm_peak = 0.0
    if _hooks_installed and _prev_excepthook is not None:
        try:
            sys.excepthook = _prev_excepthook
        except Exception:
            pass
    _hooks_installed = False
