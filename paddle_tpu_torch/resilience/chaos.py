"""Deterministic fault injection, controlled by the environment (the
port's copy of paddle_tpu/resilience/chaos.py: its spec parser, the
train step's hooks and the checkpoint drills' hooks).

    PADDLE_TPU_CHAOS="nan_at_step:3;hang_at_step:2:1.5;oom:2"

The same variable and grammar as the reference, so one spec drives both
packages: `;`-separated `name[:num[:num]]` entries. The entries the port
reads:

    nan_at_step:K         the train step produces a NaN loss (and NaN
                          gradients) at optimizer step K (jit/engine.py;
                          1-based like optimizer._step_count)
    hang_at_step:K:SECS   host-side sleep of SECS (default 5) inside the
                          dispatch of optimizer step K, under the step
                          watchdog's scope
    oom:K                 the dispatch of optimizer step K raises a
                          synthetic RESOURCE_EXHAUSTED, which drives the
                          real OOM path (memprof.on_oom: the `oom` journal
                          event, pt_oom_total, a crash bundle with
                          memory.json) without exhausting any memory

The reference's other entries (probe_timeout, sigterm_at_step,
torn_write, bitflip_ckpt and the rank faults) parse here too but nothing
of the port reads them yet. With the variable unset every hook is a cheap
no-op. Counters are in-process: each injected fault fires once per
process at its configured step. Standard library only.
"""
from __future__ import annotations

import os
import signal
import time
from typing import Dict, Optional, Tuple

__all__ = ["ENV_VAR", "configure", "reset", "get", "nan_at_step",
           "hang_before_dispatch", "oom_at_dispatch", "step_hook",
           "torn_write_blob", "bitflip_blob"]

ENV_VAR = "PADDLE_TPU_CHAOS"

_spec_cache: Optional[Tuple[str, Dict[str, Tuple[float, ...]]]] = None
_counts: Dict[str, int] = {}


def _parse(spec: str) -> Dict[str, Tuple[float, ...]]:
    out: Dict[str, Tuple[float, ...]] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        try:
            out[parts[0]] = tuple(float(p) for p in parts[1:])
        except ValueError:
            raise ValueError("bad %s entry %r (want name[:num[:num]])"
                             % (ENV_VAR, entry))
    return out


def _active() -> Dict[str, Tuple[float, ...]]:
    """The parsed spec of the variable's current value (parsed again when
    it changes, which also restarts the fire-once counters)."""
    global _spec_cache
    raw = os.environ.get(ENV_VAR, "")
    if _spec_cache is None or _spec_cache[0] != raw:
        _spec_cache = (raw, _parse(raw))
        _counts.clear()
    return _spec_cache[1]


def configure(spec: str) -> None:
    """Set the spec from code (tests): the same as setting the variable."""
    if spec:
        os.environ[ENV_VAR] = spec
    else:
        os.environ.pop(ENV_VAR, None)
    _active()


def reset() -> None:
    configure("")


def get(name: str) -> Optional[Tuple[float, ...]]:
    return _active().get(name)


def nan_at_step() -> Optional[int]:
    """The optimizer step at which the train step must produce a NaN loss,
    or None. Read once, when the step is made."""
    args = get("nan_at_step")
    return int(args[0]) if args else None


def hang_before_dispatch(step: int) -> None:
    """Engine hook: host-side sleep inside the dispatch of optimizer step
    `step` (1-based), under the step watchdog's scope."""
    args = get("hang_at_step")
    if args and int(args[0]) == step and not _counts.get("hang_%d" % step):
        _counts["hang_%d" % step] = 1
        time.sleep(args[1] if len(args) > 1 else 5.0)


def oom_at_dispatch(step: int) -> None:
    """Engine hook: raise a synthetic RESOURCE_EXHAUSTED from the dispatch
    of optimizer step `step` (1-based, once per process), spelled as the
    reference spells it, so that memprof.is_oom takes it in both
    packages."""
    args = get("oom")
    if args and int(args[0]) == step and not _counts.get("oom_%d" % step):
        _counts["oom_%d" % step] = 1
        raise RuntimeError(
            "RESOURCE_EXHAUSTED: injected by %s=oom:%d — synthetic device "
            "memory exhaustion (chaos drill)" % (ENV_VAR, step))


def step_hook(step: int) -> None:
    """Per-train-step host hook: fires `sigterm_at_step`. Call with the
    global step (the loop's 0-based batch counter, as Model.fit counts)."""
    args = get("sigterm_at_step")
    if args and int(args[0]) == step and not _counts.get("sigterm"):
        _counts["sigterm"] = 1
        os.kill(os.getpid(), signal.SIGTERM)


def torn_write_blob() -> bool:
    """True when the current checkpoint blob write must be torn
    (torn_write:K, a 1-based blob count over the process's life). The
    store then writes half the payload and SIGKILLs the process."""
    args = get("torn_write")
    if not args:
        return False
    n = _counts.get("torn_write", 0) + 1
    _counts["torn_write"] = n
    return n == int(args[0])


def bitflip_blob() -> bool:
    """True when the current checkpoint blob must have one bit flipped
    after its checksum is recorded (bitflip_ckpt:K, 1-based)."""
    args = get("bitflip_ckpt")
    if not args:
        return False
    n = _counts.get("bitflip_ckpt", 0) + 1
    _counts["bitflip_ckpt"] = n
    return n == int(args[0])
