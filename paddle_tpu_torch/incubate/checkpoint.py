"""Auto-checkpoint: periodic durable snapshots + train-loop resume (the
port's copy of paddle_tpu/incubate/checkpoint.py).

A thin wrapper over the durable checkpoint engine (checkpoint/engine.py):
saves are pickle-free verified stores committed atomically (manifest +
sha256'd blobs + COMMIT marker + fsync), loads verify integrity and
QUARANTINE + walk back to the last-good epoch instead of crashing the
resume, `save(async_=True)` overlaps the disk write with the next epoch,
and retention GC (keep-last-N / keep-every-K) prunes old epochs.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, Optional

from ..checkpoint import engine as _engine
from ..resilience import health
from ..checkpoint.engine import (CheckpointCorruptError,  # noqa: F401
                                 RetentionPolicy)

__all__ = ["TrainEpochRange", "save_checkpoint", "load_checkpoint",
           "CheckpointCorruptError", "RetentionPolicy"]

_EPOCH_RE = re.compile(r"^epoch_(\d+)$")


def save_checkpoint(path: str, layer=None, optimizer=None, meta=None,
                    **kw):
    """Durable atomic checkpoint: params (+ buffers), optimizer
    accumulators, user meta. Returns the final path (or a PendingSave
    handle with `async_=True`); see checkpoint.engine.save_checkpoint."""
    return _engine.save_checkpoint(path, layer, optimizer, meta, **kw)


def load_checkpoint(path: str, layer=None, optimizer=None, **kw) -> Dict:
    """Verified restore; returns the stored meta dict. Raises
    CheckpointCorruptError (after quarantining) on integrity failure."""
    return _engine.load_checkpoint(path, layer, optimizer, **kw)


def _epoch_num(name: str) -> Optional[int]:
    """Strictly-`epoch_<int>` names only: `epoch_3.old.991`, `.corrupt`,
    `.tmp.`/`.prev.` droppings and unrelated files all return None instead
    of crashing the resume scan (the seed's int(n.split("_")[1]) did)."""
    m = _EPOCH_RE.match(name)
    return int(m.group(1)) if m else None


class TrainEpochRange:
    """reference: auto_checkpoint.py TrainEpochRange — iterate epochs,
    checkpoint each one, and RESUME from the last finished epoch after a
    crash/restart:

        tr = TrainEpochRange(10, "job_1", checkpoint_dir="/ckpt")
        for epoch in tr.get():          # picks up where it left off
            train(...)
            tr.save(layer=net, optimizer=opt)

    Corrupt epoch dirs are quarantined at restore() time and the range
    falls back to the newest intact epoch. `keep_last`/`keep_every`
    configure retention GC (default: keep the latest two). The directory
    defaults to PADDLE_TPU_CHECKPOINT_DIR (else paddle_tpu_ckpt in the
    temporary directory), joined with `name`."""

    def __init__(self, max_epoch_num: int, name: str,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_inter: int = 1, restored: bool = True,
                 keep_last: int = 2, keep_every: Optional[int] = None):
        self.max_epoch_num = max_epoch_num
        self.name = name
        self.dir = os.path.join(
            checkpoint_dir or os.environ.get(
                "PADDLE_TPU_CHECKPOINT_DIR",
                os.path.join(tempfile.gettempdir(), "paddle_tpu_ckpt")),
            name)
        os.makedirs(self.dir, exist_ok=True)
        _engine.sweep_stale(self.dir)
        self.inter = max(1, checkpoint_inter)
        self.retention = RetentionPolicy(keep_last=keep_last,
                                         keep_every=keep_every)
        self._epoch = -1
        self._restored_meta: Dict = {}
        if restored:
            last = self._last_epoch_on_disk()
            if last is not None:
                self._epoch = last
        self._pending = None
        self._guard = None
        self.preempted = False

    def _ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.dir, f"epoch_{epoch}")

    def _epochs_on_disk(self):
        """Committed epoch numbers, ascending."""
        done = []
        for n in os.listdir(self.dir):
            e = _epoch_num(n)
            if e is None:
                continue
            p = os.path.join(self.dir, n)
            if _engine.store.is_complete(p):
                done.append(e)
        return sorted(done)

    def _last_epoch_on_disk(self) -> Optional[int]:
        done = self._epochs_on_disk()
        return done[-1] if done else None

    @property
    def restored_epoch(self) -> int:
        return self._epoch

    def restore(self, layer=None, optimizer=None) -> Dict:
        """Load the newest intact epoch's state (call before get()).
        Corrupt epochs are quarantined and skipped — `restored_epoch`
        reflects the epoch actually restored."""
        if self._epoch < 0:
            return {}
        candidates = [self._ckpt_path(e)
                      for e in reversed(self._epochs_on_disk())]
        path, meta = _engine.load_latest(candidates, layer, optimizer)
        if path is None:
            self._epoch = -1
            self._restored_meta = {}
        else:
            self._epoch = int(os.path.basename(path).split("_")[1])
            self._restored_meta = meta
        return self._restored_meta

    def get(self):
        """Epoch iterator starting AFTER the restored epoch. Preemption-safe:
        SIGTERM/SIGINT during an epoch is deferred (resilience.PreemptionGuard)
        and the range stops cleanly at the next epoch boundary — after the
        caller's `save()` — so the relaunched job resumes one epoch later."""
        from ..resilience.preemption import PreemptionGuard, active_guard
        guard = active_guard()
        if guard is None:
            guard = self._guard = PreemptionGuard().install()
        try:
            for e in range(self._epoch + 1, self.max_epoch_num):
                self._pending = e
                health.tick(e)  # epoch boundary = liveness for the launcher
                yield e
                self._pending = None
                if guard.triggered:
                    self.preempted = True
                    break
        finally:
            _engine.wait_pending()  # async epoch save must commit
            # an async save commits after save()'s retention pass ran, so
            # re-apply once the slot is drained or the last epoch escapes GC
            self.retention.apply(self.dir)
            if self._guard is not None:
                self._guard.uninstall()
                self._guard = None

    def save(self, layer=None, optimizer=None, meta=None,
             async_: bool = False, **kw):
        """Checkpoint the pending epoch (every `checkpoint_inter` epochs and
        the last). Extra keywords pass through to
        engine.save_checkpoint."""
        e = self._pending
        if e is None:
            raise RuntimeError("TrainEpochRange.save() outside get() loop")
        if (e + 1) % self.inter == 0 or e == self.max_epoch_num - 1:
            save_checkpoint(self._ckpt_path(e), layer, optimizer,
                            dict(meta or {}, epoch=e), async_=async_, **kw)
            self._epoch = e
            self.retention.apply(self.dir)
