"""Durable checkpoint engine: verified, crash-consistent, async snapshots
(the port's copy of paddle_tpu/checkpoint/engine.py, minus the sharded
and resharded saves and the legacy `ckpt.pkl` read).

Orchestration over the `store` format (manifest + blobs + COMMIT), which
is the reference's: a checkpoint written by either package loads in the
other. `incubate/checkpoint.py` is a thin wrapper over this module.

  * snapshot — the host capture: a module's `state_dict()` (parameters and
    buffers, by the reference's names and in their own dtype: a bfloat16
    parameter is stored as bfloat16) under `p/`, the optimizer's state
    dict under `o/` (its tensors) and `extras["opt"]` (the JSON-able rest:
    `@step_count`, `LR_Scheduler`). Tensors on the card are copied into
    one pinned host buffer by non-blocking copies, then ONE synchronize:
    that is the only wait on the device of a save. The writer thread
    reads that host memory and makes no CUDA call: the buffer is freed
    from the caller's thread (the `PendingSave` holds it).
  * save_checkpoint — write-and-commit atomically: the store goes into
    `<path>.tmp.<pid>-<n>`, an existing checkpoint is moved aside to
    `<path>.prev.<pid>`, the tmp dir is renamed into place and the parent
    dir fsync'd. A crash at ANY point leaves the old checkpoint, the new
    one, or a recoverable/sweepable combination — never nothing.
  * async snapshots — `save_checkpoint(..., async_=True)` returns a
    `PendingSave` after the host capture; the blob/manifest/commit work
    runs on a writer thread with ONE in-flight slot (a second async save
    waits for the first). `wait_pending` is the barrier;
    `flush_on_preemption` is what the PreemptionGuard calls in the
    SIGTERM grace window so that a pending save commits.
  * load_checkpoint — verified read; corruption quarantines the directory
    (`<path>.corrupt*`), then recovery walks `.prev`/`.tmp` siblings
    before giving up. `load_latest` walks a newest-first candidate list
    back to the last good checkpoint. A load copies INTO the module's
    parameters and buffers and the optimizer's moments (`copy_`, never a
    rebinding), so a captured train step that holds their addresses
    replays on from the loaded state with no new build.
  * RetentionPolicy — keep-last-N / keep-every-K GC over an epoch series.

The RNG state is not part of the store: a training loop puts
`framework.random.get_rng_state()` (JSON-able) into the checkpoint's
`meta` and gives it back to `set_rng_state` after a load, as the
reference's `Model.fit` keeps its key in `meta["rng_state"]`. The two
packages' generators differ (jax's threefry key against a CPU generator
and Philox words), so the RNG state never crosses between them:
`set_rng_state` raises on a state that is not the port's.

Every save, corruption, fallback and GC lands in the observability layer,
under the reference's names: pt_ckpt_saves_total{mode},
pt_ckpt_save_seconds, pt_ckpt_bytes_total, pt_ckpt_corrupt_total,
pt_ckpt_fallback_total, pt_ckpt_gc_total and the journal events
checkpoint_save / checkpoint_corrupt / checkpoint_fallback /
checkpoint_flush / checkpoint_recover / checkpoint_sweep /
checkpoint_gc.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability import journal as run_journal
from ..observability import metrics
from . import store
from .store import CheckpointCorruptError

__all__ = [
    "CheckpointCorruptError", "PendingSave", "RetentionPolicy",
    "save_checkpoint", "load_checkpoint", "load_latest", "snapshot",
    "wait_pending", "flush_on_preemption", "sweep_stale", "quarantine",
]

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

_tmp_counter = itertools.count()

# save-latency buckets: 1ms .. ~2min
_SAVE_BUCKETS = metrics.exponential_buckets(1e-3, 2.0, 18)
# each tensor's place in the pinned host buffer starts on this boundary
_ALIGN = 64


def _m_save_seconds():
    return metrics.histogram("pt_ckpt_save_seconds",
                             "Checkpoint write+commit latency",
                             buckets=_SAVE_BUCKETS)


def _m_corrupt():
    return metrics.counter("pt_ckpt_corrupt_total",
                           "Checkpoints that failed integrity verification "
                           "and were quarantined")


# ---------------------------------------------------------------------------
# state capture (the synchronous, device->host part of every save)
# ---------------------------------------------------------------------------

def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Host copies of `tensors`: CPU ones cloned; those on a card copied
    into views of one pinned buffer by non-blocking copies, then one
    synchronize."""
    out: Dict[str, torch.Tensor] = {}
    on_card = []
    for name, t in tensors.items():
        t = t.detach()
        if t.device.type == "cpu":
            out[name] = t.clone()
        else:
            on_card.append((name, t))
    if not on_card:
        return out
    offsets, total = [], 0
    for _, t in on_card:
        offsets.append(total)
        total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
    for (name, t), off in zip(on_card, offsets):
        n = t.numel() * t.element_size()
        host = buf[off:off + n].view(t.dtype).view(t.shape)
        host.copy_(t, non_blocking=True)
        out[name] = host
    for dev in {t.device for _, t in on_card}:
        torch.cuda.synchronize(dev)
    return out


def snapshot(layer=None, optimizer=None, meta=None) -> dict:
    """Host-capture a module's parameters and buffers and the optimizer's
    state, plus JSON-able extras (THE only blocking device sync of an
    async save). The returned dict is self-contained: the writer thread
    never touches live tensors. An optimizer tensor listed under two keys
    (the reference's `@acc_{i}_{name}` and `{param name}_{name}`) is
    stored once, under the first: both packages load `@acc_` keys
    first."""
    tensors: Dict[str, torch.Tensor] = {}
    arrays: Dict[str, object] = {}
    extras: dict = {}
    if layer is not None:
        for k, v in layer.state_dict().items():
            tensors["p/" + k] = v
    if optimizer is not None:
        opt_extras = {}
        seen = set()
        for k, v in optimizer.state_dict().items():
            if isinstance(v, torch.Tensor):
                if id(v) not in seen:
                    seen.add(id(v))
                    tensors["o/" + k] = v
            elif _jsonable(v):
                opt_extras[k] = v
            else:
                arrays["o/" + k] = np.asarray(v)
        extras["opt"] = opt_extras
        extras["has_opt"] = True
    host = _to_host(tensors)
    arrays = dict({k: host[k] for k in tensors}, **arrays)
    return {"arrays": arrays, "extras": extras, "meta": dict(meta or {})}


# ---------------------------------------------------------------------------
# atomic write + commit
# ---------------------------------------------------------------------------

def _commit(tmp: str, final: str) -> None:
    """Swap `tmp` (a complete store) into place. The aside dance keeps a
    committed checkpoint on disk at every instant."""
    prev = None
    if os.path.exists(final):
        prev = final + ".prev." + str(os.getpid())
        if os.path.exists(prev):
            shutil.rmtree(prev, ignore_errors=True)
        os.rename(final, prev)
    os.rename(tmp, final)
    store.fsync_dir(os.path.dirname(os.path.abspath(final)) or ".")
    if prev:
        shutil.rmtree(prev, ignore_errors=True)


def _write_and_commit(path: str, snap: dict) -> int:
    """Write `snap` durably at `path` (module-level so tests can wrap it
    with a delay to exercise async back-pressure). Returns blob bytes."""
    tmp = "%s.tmp.%d-%d" % (path, os.getpid(), next(_tmp_counter))
    if os.path.exists(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
    try:
        nbytes = store.write_store(tmp, snap["arrays"], meta=snap["meta"],
                                   extras=snap["extras"])
        _commit(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return nbytes


def _do_write(path: str, snap: dict, mode: str) -> str:
    t0 = time.perf_counter()
    nbytes = _write_and_commit(path, snap)
    dt = time.perf_counter() - t0
    metrics.counter("pt_ckpt_saves_total", "Committed checkpoint saves",
                    ("mode",)).labels(mode).inc()
    metrics.counter("pt_ckpt_bytes_total",
                    "Checkpoint blob bytes committed").inc(nbytes)
    _m_save_seconds().observe(dt)
    run_journal.emit("checkpoint_save", path=str(path), bytes=nbytes,
                     duration_s=round(dt, 6), mode=mode)
    return path


# ---------------------------------------------------------------------------
# async writer: one in-flight slot, explicit barrier
# ---------------------------------------------------------------------------

class PendingSave:
    """Handle for an in-flight async save. `wait()` is the barrier: it
    returns the committed path or re-raises the writer's exception."""

    def __init__(self, path: str):
        self.path = path
        self._snap: Optional[dict] = None
        self._done = threading.Event()
        self._exc: Optional[BaseException] = None
        self._result: Optional[str] = None

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> str:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"async checkpoint save to {self.path!r} still in flight "
                f"after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result


_inflight: Optional[PendingSave] = None
_inflight_lock = threading.Lock()


def _submit(path: str, snap: dict) -> PendingSave:
    global _inflight
    with _inflight_lock:
        prev = _inflight
    if prev is not None and not prev.done:
        # back-pressure: ONE in-flight slot. The caller's step loop blocks
        # here only when it outruns the disk.
        try:
            prev.wait()
        except Exception as e:
            logger.warning("previous async checkpoint save failed: %s", e)
    handle = PendingSave(path)
    # the handle, which the caller's thread holds, keeps the snapshot's
    # host buffers: the writer thread never drops their last reference,
    # so it never frees pinned memory (a CUDA call) itself
    handle._snap = snap

    def run():
        try:
            handle._result = _do_write(path, handle._snap, mode="async")
        except BaseException as e:  # surfaced via wait()
            handle._exc = e
            logger.error("async checkpoint save to %s failed: %s", path, e)
        finally:
            handle._done.set()

    with _inflight_lock:
        _inflight = handle
    threading.Thread(target=run, name="pt-ckpt-writer", daemon=True).start()
    return handle


def wait_pending(timeout: Optional[float] = None) -> None:
    """Barrier: block until the in-flight async save (if any) commits.
    Re-raises the writer's exception."""
    with _inflight_lock:
        handle = _inflight
    if handle is not None:
        handle.wait(timeout)


def flush_on_preemption(timeout: Optional[float] = None) -> None:
    """Called by PreemptionGuard inside the SIGTERM grace window: give the
    in-flight async save up to PADDLE_TPU_PREEMPT_FLUSH_S (default 10s) to
    commit, so preemption never loses a snapshot already captured. Never
    raises (runs in a signal handler)."""
    with _inflight_lock:
        handle = _inflight
    if handle is None or handle.done:
        return
    if timeout is None:
        try:
            timeout = float(os.environ.get("PADDLE_TPU_PREEMPT_FLUSH_S",
                                           "10"))
        except ValueError:
            timeout = 10.0
    t0 = time.monotonic()
    try:
        handle.wait(timeout)
        run_journal.emit("checkpoint_flush", path=str(handle.path),
                         waited_s=round(time.monotonic() - t0, 3))
    except Exception as e:
        run_journal.emit("checkpoint_flush", path=str(handle.path),
                         waited_s=round(time.monotonic() - t0, 3),
                         error=str(e))


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, layer=None, optimizer=None, meta=None, *,
                    async_: bool = False):
    """Durable checkpoint save. Returns the committed path, or a
    `PendingSave` when `async_=True` (the host capture happens
    synchronously either way; only the disk work moves off-thread)."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    snap = snapshot(layer, optimizer, meta)
    if async_:
        return _submit(path, snap)
    return _do_write(path, snap, mode="sync")


# ---------------------------------------------------------------------------
# verified load + quarantine + fallback
# ---------------------------------------------------------------------------

def quarantine(path: str, reason: str = "corrupt") -> Optional[str]:
    """Move a failed checkpoint aside as `<path>.corrupt[.N]` (kept for
    forensics, invisible to resume scans). Returns the new path."""
    if not os.path.exists(path):
        return None
    dst = path + ".corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = "%s.corrupt.%d" % (path, n)
    os.rename(path, dst)
    _m_corrupt().inc()
    run_journal.emit("checkpoint_corrupt", path=str(path),
                     quarantined=str(dst), reason=reason)
    logger.warning("checkpoint %s corrupt (%s): quarantined to %s",
                   path, reason, dst)
    return dst


def _recover_sibling(path: str) -> bool:
    """After a crash between commit renames, a COMPLETE `.prev.*`/`.tmp.*`
    sibling may hold the only good copy — rename it back into place."""
    base = os.path.basename(path)
    parent = os.path.dirname(os.path.abspath(path))
    if not os.path.isdir(parent):
        return False
    for n in sorted(os.listdir(parent), reverse=True):
        if not (n.startswith(base + ".prev.") or
                n.startswith(base + ".tmp.")):
            continue
        if _owner_alive(n):
            continue  # a live writer's commit in flight, not a crash relic
        cand = os.path.join(parent, n)
        if store.is_complete(cand):
            if os.path.exists(path):
                shutil.rmtree(path, ignore_errors=True)
            os.rename(cand, path)
            store.fsync_dir(parent)
            run_journal.emit("checkpoint_recover", path=str(path),
                             source=n)
            logger.warning("recovered checkpoint %s from %s", path, n)
            return True
    return False


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.asarray(v))


@torch.no_grad()
def _restore(arrays, extras, layer=None, optimizer=None) -> None:
    """Copy a store's arrays into the module and the optimizer in place.
    As the reference's `set_state_dict`, names the module lacks are
    skipped, and a shape that differs raises."""
    if layer is not None:
        own = layer.state_dict(keep_vars=True)
        for k, v in arrays.items():
            if not k.startswith("p/") or k[2:] not in own:
                continue
            dst, src = own[k[2:]], _as_tensor(v)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError("shape mismatch for %s: got %s, expected %s"
                                 % (k[2:], list(src.shape), list(dst.shape)))
            dst.copy_(src)
    if optimizer is not None and extras.get("has_opt"):
        opt_state = {k[2:]: v for k, v in arrays.items()
                     if k.startswith("o/")}
        opt_state.update(extras.get("opt", {}))
        optimizer.set_state_dict(opt_state)


def load_checkpoint(path: str, layer=None, optimizer=None, *,
                    fallback: bool = True) -> dict:
    """Verified restore; returns the stored meta dict.

    Corruption path: quarantine the directory, then (with `fallback`) try
    to recover a complete `.prev`/`.tmp` sibling of the SAME logical path;
    if none, re-raise `CheckpointCorruptError` — series-level walk-back to
    older checkpoints is `load_latest`."""
    if not store.is_complete(path):
        # never-committed dir (torn write): sweep, then try recovery
        if os.path.exists(path):
            shutil.rmtree(path, ignore_errors=True)
        if not _recover_sibling(path):
            raise CheckpointCorruptError(path, "incomplete",
                                         "no committed checkpoint")
    try:
        arrays, meta, extras = store.read_store(path)
    except CheckpointCorruptError as e:
        quarantine(path, reason=e.reason)
        if fallback and _recover_sibling(path):
            arrays, meta, extras = store.read_store(path)
        else:
            raise
    _restore(arrays, extras, layer, optimizer)
    return meta


def load_latest(candidates: Sequence[str], layer=None, optimizer=None
                ) -> Tuple[Optional[str], dict]:
    """Walk a newest-first candidate list to the last-good checkpoint.
    Corrupt entries are quarantined as a side effect; a successful load
    after at least one corruption counts as a fallback
    (`pt_ckpt_fallback_total` + `checkpoint_fallback` journal event).
    Returns (path, meta) or (None, {}) when nothing is loadable."""
    first_bad = None
    for cand in candidates:
        try:
            meta = load_checkpoint(cand, layer, optimizer)
        except CheckpointCorruptError:
            if first_bad is None:
                first_bad = cand
            continue
        if first_bad is not None:
            metrics.counter("pt_ckpt_fallback_total",
                            "Resumes that fell back past a corrupt "
                            "checkpoint to an older one").inc()
            run_journal.emit("checkpoint_fallback", wanted=str(first_bad),
                             used=str(cand))
            logger.warning("checkpoint fallback: %s corrupt, resumed from "
                           "%s", first_bad, cand)
        return cand, meta
    return None, {}


# ---------------------------------------------------------------------------
# hygiene: stale-dir sweep + retention GC
# ---------------------------------------------------------------------------

_STALE_MARKERS = (".tmp.", ".prev.", ".old.")


def _owner_alive(name: str) -> bool:
    """True when the pid embedded in a `.tmp.<pid>-<n>` / `.prev.<pid>` /
    `.old.<pid>` suffix belongs to a LIVE process other than us — its
    commit is in flight, not stale."""
    for marker in _STALE_MARKERS:
        if marker in name:
            pid_part = name.rsplit(marker, 1)[1].split("-")[0]
            break
    else:
        return False
    try:
        pid = int(pid_part)
    except ValueError:
        return False
    if pid == os.getpid():
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else


def sweep_stale(root: str) -> List[str]:
    """Remove crash droppings under `root`: `.tmp.`/`.prev.` dirs from an
    interrupted commit (after attempting sibling recovery) and legacy
    `.old.<pid>` aside dirs. Dirs whose owner pid is still alive are left
    alone. Returns the removed names."""
    removed = []
    if not os.path.isdir(root):
        return removed
    for n in sorted(os.listdir(root)):
        if not any(m in n for m in _STALE_MARKERS):
            continue
        if _owner_alive(n):
            continue
        p = os.path.join(root, n)
        if not os.path.isdir(p):
            continue
        for m in (".tmp.", ".prev."):
            if m in n:
                final = os.path.join(root, n.split(m)[0])
                if not store.is_complete(final) and store.is_complete(p):
                    # only durable copy of this checkpoint — recover it
                    if os.path.exists(final):
                        shutil.rmtree(final, ignore_errors=True)
                    os.rename(p, final)
                    store.fsync_dir(root)
                    run_journal.emit("checkpoint_recover", path=str(final),
                                     source=n)
                    p = None
                break
        if p is not None:
            shutil.rmtree(p, ignore_errors=True)
            removed.append(n)
    if removed:
        run_journal.emit("checkpoint_sweep", root=str(root),
                         removed=removed)
    return removed


class RetentionPolicy:
    """keep-last-N / keep-every-K GC over an `<prefix><num>` series.

        RetentionPolicy(keep_last=2, keep_every=10).apply(dir)

    keeps the newest 2 checkpoints plus every 10th epoch forever (cheap
    long-horizon rollback points). Quarantined/stale names never match the
    pattern and are left alone."""

    def __init__(self, keep_last: int = 2,
                 keep_every: Optional[int] = None):
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1 (a retention policy "
                             "that keeps nothing is a delete-all)")
        if keep_every is not None and keep_every < 1:
            raise ValueError("keep_every must be >= 1")
        self.keep_last = int(keep_last)
        self.keep_every = None if keep_every is None else int(keep_every)

    def apply(self, root: str, prefix: str = "epoch_") -> List[str]:
        pat = re.compile(r"^%s(\d+)$" % re.escape(prefix))
        found = []
        for n in os.listdir(root):
            m = pat.match(n)
            if m and os.path.isdir(os.path.join(root, n)):
                found.append((int(m.group(1)), n))
        found.sort()
        doomed = found[:-self.keep_last]
        removed = []
        for num, n in doomed:
            if self.keep_every is not None and num % self.keep_every == 0:
                continue
            shutil.rmtree(os.path.join(root, n), ignore_errors=True)
            removed.append(n)
        if removed:
            metrics.counter("pt_ckpt_gc_total",
                            "Checkpoints removed by retention GC"
                            ).inc(len(removed))
            run_journal.emit("checkpoint_gc", root=str(root),
                             removed=removed)
        return removed
