"""Durable checkpoints (the port's counterpart of paddle_tpu/checkpoint).

Pickle-free verified tensor store (`store`: manifest + sha256'd blobs +
COMMIT marker, fsync discipline; the reference's format, so that each
package reads the other's checkpoints) and the orchestration over it
(`engine`: atomic commit, async snapshots with one in-flight slot,
corruption quarantine + last-good fallback, retention GC).
`incubate/checkpoint.py` is a thin wrapper over this package.
"""
from . import engine, store  # noqa: F401
from .engine import (CheckpointCorruptError, PendingSave,  # noqa: F401
                     RetentionPolicy, flush_on_preemption, load_checkpoint,
                     load_latest, save_checkpoint, snapshot, sweep_stale,
                     wait_pending)

__all__ = [
    "engine", "store", "CheckpointCorruptError", "PendingSave",
    "RetentionPolicy", "save_checkpoint", "load_checkpoint", "load_latest",
    "snapshot", "wait_pending", "flush_on_preemption", "sweep_stale",
]
