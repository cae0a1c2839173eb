"""Structured run journal: append-only JSONL event log, one file per rank.

The port's copy of paddle_tpu/observability/journal.py. Every operational
event (a serving admission, a completion, a shed request) is one JSON line
with a shared envelope

    {"ts": ..., "run_id": ..., "rank": ..., "host": ..., "pid": ...,
     "event": "<type>", ...event fields}

Module-level `emit()` routes through the process-wide active journal
(installed with `set_journal`) and is a cheap no-op when none is
installed, so deep callers emit unconditionally. Every record, with or
without a journal file, is also mirrored into the flight recorder's ring
(observability/flight.py), so a crash bundle carries the recent event
history. Pure stdlib.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from typing import Optional

__all__ = ["RunJournal", "set_journal", "get_journal", "emit"]

logger = logging.getLogger("paddle_tpu_torch.journal")

_flight = None  # unresolved → module or False after first tap


def _flight_tap(rec: dict) -> None:
    """Mirror a journal record into the flight recorder's ring. Lazy and
    resolved once (a standalone load without the package resolves to
    False and skips for good)."""
    global _flight
    if _flight is None:
        try:
            from . import flight as _mod
            _flight = _mod
        except Exception:
            _flight = False
    if _flight:
        _flight.record_raw(rec)


def _default_rank() -> int:
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    except ValueError:
        return 0


class RunJournal:
    """Append-only JSONL event log with size-based rotation.

        j = RunJournal("/tmp/run", run_id="r1", rank=0)
        j.emit("serve_admit", rid=3, slot=0)

    The file is `<dir>/journal-rank<rank>.jsonl`; when it exceeds
    `rotate_bytes` it is renamed to `<file>.1` (one generation kept) and a
    fresh file is started. Writes are flushed per line so a kill loses at
    most the current line."""

    def __init__(self, directory: str, run_id: Optional[str] = None,
                 rank: Optional[int] = None,
                 rotate_bytes: int = 64 * 1024 * 1024,
                 filename: Optional[str] = None):
        self.directory = directory
        self.rank = _default_rank() if rank is None else int(rank)
        self.run_id = run_id or time.strftime("%Y%m%dT%H%M%S") + \
            "-p%d" % os.getpid()
        self.rotate_bytes = int(rotate_bytes)
        self.host = socket.gethostname()
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(
            directory, filename or "journal-rank%d.jsonl" % self.rank)
        self._lock = threading.RLock()
        self._f = open(self.path, "a")
        self._size = self._f.tell()
        self.events_written = 0

    def emit(self, event: str, **fields) -> bool:
        """Append one event line. Never raises (a failing journal must not
        take down the run it observes); returns write success."""
        rec = {"ts": round(time.time(), 6), "run_id": self.run_id,
               "rank": self.rank, "host": self.host, "pid": os.getpid(),
               "event": event}
        rec.update(fields)
        try:
            _flight_tap(rec)
        except Exception:
            pass
        try:
            line = json.dumps(rec, default=str) + "\n"
        except (TypeError, ValueError) as e:
            logger.warning("journal: unserializable %r event dropped: %s",
                           event, e)
            return False
        with self._lock:
            try:
                if self._f.closed:
                    return False
                if self._size + len(line) > self.rotate_bytes and \
                        self._size > 0:
                    self._rotate()
                self._f.write(line)
                self._f.flush()
                self._size += len(line)
                self.events_written += 1
                return True
            except OSError as e:
                logger.warning("journal write failed: %s", e)
                return False

    def _rotate(self):
        self._f.close()
        os.replace(self.path, self.path + ".1")
        self._f = open(self.path, "a")
        self._size = 0

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_active: Optional[RunJournal] = None
_active_lock = threading.Lock()


def set_journal(journal: Optional[RunJournal]) -> Optional[RunJournal]:
    """Install `journal` as the process-wide event sink; returns the
    previous one (callers restore it when their scope ends)."""
    global _active
    with _active_lock:
        prev = _active
        _active = journal
    return prev


def get_journal() -> Optional[RunJournal]:
    return _active


def emit(event: str, **fields) -> bool:
    """Emit into the active journal (no-op without one). Also mirrors to
    the `paddle_tpu_torch.journal` logger at DEBUG."""
    j = _active
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug("%s %s", event, fields)
    if j is None:
        # no journal file, but the flight ring still wants the event
        try:
            rec = {"ts": round(time.time(), 6), "event": event}
            rec.update(fields)
            _flight_tap(rec)
        except Exception:
            pass
        return False
    return j.emit(event, **fields)
