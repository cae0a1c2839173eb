"""Asynchronous device feed (counterpart of paddle_tpu/io/prefetch.py
DevicePrefetcher / prefetch_to_device).

A feeder thread pulls batches from the source iterator and, for a CUDA
device, pins each host tensor (unless it is pinned already) and copies it
to the card with non_blocking=True on a copy stream of its own, recording
an event; a tensor already on the card passes as it is. A
bounded queue (size 2: double buffering) holds at most `size` batches
ahead. The consumer's `next()` makes its current stream wait on the
batch's event (a device-side wait, no host sync) and marks each tensor
used by that stream (`record_stream`), so the caching allocator neither
reuses a batch's block while the compute stream reads it nor hands a
freed compute-stream block to a copy in flight. For a CPU device the
feeder passes the batches through in order.

Every `next()` that returns a batch observes the milliseconds the
consumer waited into `pt_feed_stall_ms` (0 included, so the mean is the
stall per batch; `observability.tracing` owns the histogram), as the
reference does.

Errors in the feeder, including the source's, are raised in the consumer;
`close()` stops and joins the feeder, then closes the source.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import torch

from ..framework.device import resolve_device
from ..observability import tracing
from ..observability.tracing import FEED_STALL

__all__ = ["DevicePrefetcher", "prefetch_to_device", "FEED_STALL"]

_STOP_POLL_S = 0.05


def _tensors(obj):
    if isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)
    elif isinstance(obj, torch.Tensor):
        yield obj


def _map(obj, fn):
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _map(v, fn) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    return obj


class DevicePrefetcher:
    """Iterator over the source's batches, placed on `device`."""

    def __init__(self, iterator: Iterator, size: int = 2, device=None):
        self._src = iter(iterator)
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self._device) if self._cuda
                             else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(size)))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._feed, name="pt-device-feed", daemon=True)
        self._thread.start()

    # -- feeder side -------------------------------------------------------
    def _copy(self, batch):
        if not self._cuda:
            return batch, None
        with torch.cuda.stream(self._copy_stream):
            out = _map(batch, self._place)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return out, event

    def _place(self, t):
        """t on the card: a tensor already there as it is, a host tensor
        through pinned memory (itself where it is pinned already: the
        worker loader's batches are), so the copy is asynchronous."""
        if t.device.type == "cuda":
            return t
        src = t if t.is_pinned() else t.pin_memory()
        return src.to(self._device, non_blocking=True)

    def _feed(self):
        try:
            for batch in self._src:
                if not self._put(("item", self._copy(batch))):
                    return
        except BaseException as exc:  # noqa: BLE001 - raised in consumer
            self._put(("exc", exc))
            return
        self._put(("end", None))

    def _put(self, msg) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=_STOP_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer side -----------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        kind, payload = self._q.get()
        if kind == "item":
            tracing.record_feed_stall((time.perf_counter() - t0) * 1e3)
            batch, event = payload
            if event is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(event)
                for t in _tensors(batch):
                    t.record_stream(stream)
            return batch
        self._done = True
        if kind == "exc":
            raise payload
        raise StopIteration

    def close(self):
        self._done = True
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if not self._thread.is_alive():
            close = getattr(self._src, "close", None)
            if callable(close):
                close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def prefetch_to_device(iterator: Iterator, size: int = 2,
                       device=None) -> DevicePrefetcher:
    return DevicePrefetcher(iterator, size=size, device=device)
