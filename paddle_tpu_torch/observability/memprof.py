"""Memory forensics on CUDA: one device-memory sampler, executable memory
attribution, and OOM post-mortems (the port's counterpart of
paddle_tpu/observability/memprof.py, same public names and gauges).

  * **One sampler.** `read_device_memory()` reads the caching allocator's
    own counters (`torch.cuda.memory_allocated` / `max_memory_allocated`).
    They are host-side: no CUDA call, no synchronize, nothing that a graph
    capture on another thread could trip over. flight.sample_hbm
    delegates here.
  * **Executable attribution.** `bank_executable(engine, analysis)` keeps
    one memory analysis per engine (argument / output / temp bytes) and
    exports `pt_hbm_args_bytes` / `pt_hbm_temp_bytes`. The serving engine
    banks each step program it builds: its held tensors as arguments and,
    on CUDA, its graphs' memory pool as temp bytes. The /statusz hbm block
    and the OOM bundle read it back.
  * **Phase timeline.** `note_sample()` keeps a bounded (ts, phase,
    in_use, peak) history beside the flight ring's `hbm` events.
  * **OOM forensics.** `on_oom(engine, exc)` writes an `oom` journal
    event, counts `pt_oom_total`, and dumps a crash bundle whose
    memory.json lists the largest live device allocations (the
    allocator's active blocks), the executable bank and the history.

The readers return None until CUDA has been initialised (on the CPU
always), as the reference's return None without JAX. The H100's memory
is HBM3, so the `pt_hbm_*` names stay true. Every public function is
best-effort: observing memory must never be what exhausts it.
"""
from __future__ import annotations

import collections
import os
import time
from typing import Optional, Tuple

import torch

from . import metrics

__all__ = [
    "read_device_memory", "device_kind", "sample", "note_sample",
    "hbm_history", "bank_executable", "executable_bank",
    "analysis_from_arrays", "live_buffer_table", "is_oom", "on_oom",
    "reset",
]

ENV_HISTORY = "PADDLE_TPU_HBM_HISTORY"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


#: (ts, phase, in_use, peak) samples, oldest first
_history = collections.deque(maxlen=max(8, _env_int(ENV_HISTORY, 64)))
#: engine/label -> memory-analysis dict (last one banked wins per key)
_bank: dict = {}
_g_args = _g_temp = None
_oom_counter = None


# ----------------------------------------------------------------- sampler
def read_device_memory() -> Optional[Tuple[int, Optional[int]]]:
    """(bytes allocated, peak bytes allocated) of the current CUDA device
    from the caching allocator's counters, or None when CUDA was never
    initialised in this process or the read failed."""
    try:
        if not torch.cuda.is_initialized():
            return None
        return (int(torch.cuda.memory_allocated()),
                int(torch.cuda.max_memory_allocated()))
    except Exception:
        return None


def device_kind() -> Optional[str]:
    """Name of the current CUDA device ("NVIDIA H100 80GB HBM3", ...);
    None when CUDA was never initialised."""
    try:
        if not torch.cuda.is_initialized():
            return None
        return str(torch.cuda.get_device_name())
    except Exception:
        return None


def note_sample(in_use: int, peak: Optional[float],
                phase: Optional[str] = None) -> None:
    """Append one sample to the bounded history (called by
    flight.sample_hbm after the gauges are set). Never raises."""
    try:
        _history.append({"ts": round(time.time(), 6), "phase": phase,
                         "in_use": int(in_use),
                         "peak": int(peak) if peak is not None else None})
    except Exception:
        pass


def sample(phase: Optional[str] = None, force: bool = False
           ) -> Optional[int]:
    """Phase-boundary sample: delegates to flight.sample_hbm (rate limit,
    gauges, ring), tagging the history entry with `phase`."""
    try:
        from . import flight
        return flight.sample_hbm(force=force, phase=phase)
    except Exception:
        return None


def hbm_history() -> list:
    """Snapshot of the sample history, oldest first."""
    return list(_history)


# ------------------------------------------------------- executable bank
def bank_executable(engine: str, analysis: Optional[dict]) -> None:
    """Bank one engine's memory analysis and export the gauges. The dict
    carries args_bytes/out_bytes/temp_bytes/gen_code_bytes/total_bytes and
    a "source" tag ("cuda_graph" for a captured program, whose temp bytes
    are its memory pool; "avals" for an estimate from tensor sizes)."""
    global _g_args, _g_temp
    if not analysis:
        return
    try:
        _bank[str(engine)] = dict(analysis)
        if _g_args is None:
            _g_args = metrics.gauge(
                "pt_hbm_args_bytes",
                "Step-program argument bytes per engine (the tensors a "
                "program holds)",
                labelnames=("engine",))
            _g_temp = metrics.gauge(
                "pt_hbm_temp_bytes",
                "Step-program temp bytes per engine (its CUDA graph "
                "memory pool; 0 when only estimated)",
                labelnames=("engine",))
        _g_args.labels(engine).set(float(analysis.get("args_bytes") or 0))
        _g_temp.labels(engine).set(float(analysis.get("temp_bytes") or 0))
    except Exception:
        pass


def executable_bank() -> dict:
    """engine -> banked memory-analysis dict (copies)."""
    return {k: dict(v) for k, v in _bank.items()}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(getattr(x, "nbytes", 0) or 0)


def analysis_from_arrays(args, outs=None) -> Optional[dict]:
    """"avals"-source analysis from concrete tensors: what the dispatch
    holds and returns. Temp bytes are unknowable from outside, so 0."""
    try:
        def _tot(xs):
            total = 0
            for x in xs or ():
                for leaf in (x if isinstance(x, (list, tuple)) else (x,)):
                    total += _nbytes(leaf)
            return total
        return {"source": "avals", "args_bytes": _tot(args),
                "out_bytes": _tot(outs), "temp_bytes": 0,
                "gen_code_bytes": 0,
                "total_bytes": _tot(args) + _tot(outs)}
    except Exception:
        return None


# ------------------------------------------------------------ OOM path
def live_buffer_table(top_n: int = 15) -> Optional[dict]:
    """The largest live device allocations, grouped by (block bytes,
    pool): the "what was holding the memory" table of the OOM bundle.
    Read from `torch.cuda.memory_snapshot()`'s active blocks, a host-side
    copy of the allocator's books: it allocates nothing on the device. A
    block of a CUDA graph's private pool reads pool "graph". None when
    CUDA was never initialised."""
    try:
        if not torch.cuda.is_initialized():
            return None
        groups: dict = {}
        total = n = 0
        for seg in torch.cuda.memory_snapshot():
            pool = ("graph" if tuple(seg.get("segment_pool_id", (0, 0)))
                    != (0, 0) else "allocator")
            for blk in seg.get("blocks", ()):
                if not str(blk.get("state", "")).startswith("active"):
                    continue
                size = int(blk.get("size", 0))
                cnt, tot = groups.get((size, pool), (0, 0))
                groups[(size, pool)] = (cnt + 1, tot + size)
                total += size
                n += 1
        rows = [{"block_bytes": size, "pool": pool, "count": cnt,
                 "total_bytes": tot}
                for (size, pool), (cnt, tot) in groups.items()]
        rows.sort(key=lambda r: -r["total_bytes"])
        return {"n_arrays": n, "total_bytes": total,
                "groups": rows[:max(1, int(top_n))],
                "n_groups": len(rows)}
    except Exception:
        return None


def is_oom(exc: BaseException) -> bool:
    """`torch.cuda.OutOfMemoryError`, or the reference's two spellings of
    RESOURCE_EXHAUSTED (so one synthetic drill serves both packages)."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = "%s %s" % (type(exc).__name__, exc)
    return "RESOURCE_EXHAUSTED" in msg or "Resource exhausted" in msg


def on_oom(engine: str, exc: BaseException,
           step: Optional[int] = None) -> Optional[str]:
    """OOM post-mortem, called from the dispatch catch before the
    exception unwinds: `oom` journal event + pt_oom_total, then a crash
    bundle whose memory.json names the live allocations, the per-engine
    analyses and the sample history. It only reads host-side counters and
    writes files: an OOM inside a capture leaves the capture stream
    mid-capture, and nothing here may touch it. Returns the bundle path
    (None when no flight dir is configured). Never raises: the original
    error stays the one the caller sees."""
    global _oom_counter
    try:
        if _oom_counter is None:
            _oom_counter = metrics.counter(
                "pt_oom_total",
                "Out-of-memory dispatches caught (real or synthetic)")
        _oom_counter.inc()
    except Exception:
        pass
    try:
        from . import journal
        journal.emit("oom", engine=engine, step=step,
                     error=str(exc)[:500])
    except Exception:
        pass
    payload = None
    try:
        payload = {
            "engine": engine,
            "step": step,
            "error": "%s: %s" % (type(exc).__name__, str(exc)[:2000]),
            "device_kind": device_kind(),
            "buffers": live_buffer_table(),
            "executables": executable_bank(),
            "hbm_history": hbm_history(),
        }
    except Exception:
        pass
    try:
        from . import flight
        flight.record("oom", engine=engine, step=step)
        return flight.dump_crash_bundle("oom", exc=exc, last_step=step,
                                        memory=payload)
    except Exception:
        return None


def reset() -> None:
    """Test isolation: clear the history and the executable bank (the
    gauge objects live in the metrics registry and are reset there)."""
    global _g_args, _g_temp, _oom_counter
    _history.clear()
    _bank.clear()
    _g_args = _g_temp = None
    _oom_counter = None
