"""Multiprocess DataLoader workers with shared-memory batch transport (the
port's copy of paddle_tpu/io/multiprocess.py).

Worker PROCESSES decode and collate batches into numpy arrays; each
array of 1 KiB or more crosses back through a
multiprocessing.shared_memory segment (one memcpy in the worker), with
only small metadata pickled through the result queue. Batch order is
kept by a reorder buffer, an exception in a worker is raised in the
parent with the worker's traceback, a worker that dies raises
`DataLoaderWorkerError` and its segments are unlinked, and `close`
reclaims everything.

Workers never touch CUDA: they make numpy arrays (or CPU tensors, through
a user's collate_fn), and the parent makes the torch tensors. For a
loader on a CUDA device the parent copies each segment straight into a
pinned host tensor (`pin=True`), so that the later non_blocking copy
to the card is asynchronous: a shared-memory segment is pageable, and a
non_blocking copy from pageable memory would run synchronously.

Start method: fork shares the dataset without pickling and starts fast,
but a child forked after CUDA is initialised in the parent cannot use
the driver and may deadlock on locks held at the fork. So the port forks
while `torch.cuda.is_initialized()` is False and spawns after (the
dataset must then pickle: a class at module level); PADDLE_TPU_MP_START
overrides. Importing this package in a spawned worker initialises no
CUDA.

Map-style datasets only; an IterableDataset is batched in the consumer's
process.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from multiprocessing import shared_memory

import numpy as np
import torch

_SHM_MIN_BYTES = 1024  # below this, pickling through the queue is cheaper

__all__ = ["DataLoaderWorkerError", "MultiprocessIter"]


class DataLoaderWorkerError(RuntimeError):
    """A DataLoader worker process died without reporting a result (OOM
    kill, segfault, os._exit in user code). The message names the dead
    worker's pid and exit code; its orphaned shm segments are unlinked
    before this is raised."""


# --------------------------------------------------------------------------
# payload (de)serialization: nested lists/tuples/dicts of arrays + scalars

def _as_numpy(obj):
    """A CPU tensor from a user's collate_fn crosses as numpy, marked so
    the parent gives back a tensor; a dtype numpy lacks pickles whole."""
    if isinstance(obj, torch.Tensor) and obj.dtype not in (
            torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        return obj.detach().cpu().numpy(), True
    return obj, False


def _pack_raw(obj):
    if isinstance(obj, dict):
        return {"__dict__": {k: _pack_raw(v) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack_raw(o) for o in obj)
    return ("__raw__", obj)


def _pack(obj, segments, register=None):
    if isinstance(obj, dict):
        return {"__dict__": {k: _pack(v, segments, register)
                             for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(o, segments, register) for o in obj)
    arr, was_tensor = _as_numpy(obj)
    if isinstance(arr, np.ndarray) and arr.nbytes >= _SHM_MIN_BYTES:
        shm = shared_memory.SharedMemory(create=True, size=arr.nbytes)
        if register is not None:
            # record the name the instant the segment exists, so a worker
            # killed mid-pack never strands an unregistered segment
            register(shm.name)
        view = np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)
        view[...] = arr
        segments.append(shm)
        return ("__shm__", shm.name, arr.shape, str(arr.dtype), was_tensor)
    return ("__raw__", obj)


def _from_segment(shape, dtype, buf, as_tensor, pin):
    """A copy of the segment: a tensor where `as_tensor` (pinned where
    `pin`; a dtype torch lacks stays numpy), else a numpy array."""
    src = np.ndarray(shape, dtype, buffer=buf)
    if not as_tensor:
        return src.copy()
    try:
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError:
        return src.copy()
    out = torch.empty(shape, dtype=tdtype, pin_memory=pin)
    if src.size:
        out.numpy()[...] = src
    return out


def _unpack(obj, as_tensor=False, pin=False):
    """The batch, its shared-memory arrays copied out (and unlinked): as
    tensors where `as_tensor` or the worker's collate made a tensor, else
    as numpy arrays. What crossed the queue comes back as it was."""
    if isinstance(obj, dict):
        return {k: _unpack(v, as_tensor, pin)
                for k, v in obj["__dict__"].items()}
    if isinstance(obj, (list, tuple)) and not (
            len(obj) and obj[0] in ("__shm__", "__raw__")):
        return type(obj)(_unpack(o, as_tensor, pin) for o in obj)
    if obj[0] == "__raw__":
        return obj[1]
    _, name, shape, dtype, was_tensor = obj
    shm = shared_memory.SharedMemory(name=name)
    try:
        # COPY out of the segment: it is unlinked right after, and a
        # tensor aliasing it would read freed memory
        return _from_segment(shape, np.dtype(dtype), shm.buf,
                             as_tensor or was_tensor, pin)
    finally:
        shm.close()
        shm.unlink()


def _pick_start_method():
    """fork while CUDA is not initialised in this process, spawn once it
    is (a forked child cannot use the parent's CUDA context, and inherits
    its locks in whatever state the fork found them).
    PADDLE_TPU_MP_START always overrides."""
    env = os.environ.get("PADDLE_TPU_MP_START")
    if env:
        return env
    return "spawn" if torch.cuda.is_initialized() else "fork"


def _worker_loop(dataset, collate_fn, index_queue, result_queue, wid,
                 num_workers, worker_init_fn, seed, use_shm=True,
                 reg_dir=None):
    """One worker process: pull index lists, push packed batches."""
    from . import _set_worker_info
    _set_worker_info(wid, num_workers, dataset, seed)
    np.random.seed((seed + wid) % (2 ** 32))
    if worker_init_fn is not None:
        worker_init_fn(wid)
    while True:
        job = index_queue.get()
        if job is None:
            break
        bidx, indices = job
        try:
            batch = collate_fn([dataset[i] for i in indices])
            segments = []
            if use_shm:
                # shm registration side-channel: one file per batch, a name
                # line flushed per segment AS IT IS CREATED. A queue is not
                # crash-safe here (put() hands the bytes to a feeder
                # thread, and os._exit/SIGKILL can drop them); a write()
                # that returned is visible to the consumer however we die.
                if reg_dir is not None:
                    with open(os.path.join(
                            reg_dir, f"b{bidx}-w{wid}"), "w") as rf:
                        payload = _pack(
                            batch, segments,
                            register=lambda n: (rf.write(n + "\n"),
                                                rf.flush()))
                else:
                    payload = _pack(batch, segments)
            else:  # small-/dev/shm hosts: pickle through the queue
                payload = _pack_raw(batch)
            # ownership moves to the consumer (it unlinks): close our
            # mapping and unregister from the resource_tracker BEFORE the
            # put, or the tracker's name set collapses the consumer's
            # registration with ours
            for shm in segments:
                shm.close()
                try:
                    from multiprocessing import resource_tracker
                    resource_tracker.unregister(shm._name, "shared_memory")
                except Exception:  # pragma: no cover
                    pass
            result_queue.put((bidx, payload, None))
        except Exception:
            result_queue.put((bidx, None, traceback.format_exc()))


class MultiprocessIter:
    """Ordered multi-worker iterator over batch index lists.
    `as_tensor`: give shared-memory arrays back as tensors (the default
    collate's); `pin`: in pinned host memory."""

    def __init__(self, dataset, collate_fn, index_iter, num_workers,
                 prefetch_factor=2, worker_init_fn=None, seed=0,
                 timeout=0, use_shared_memory=True, as_tensor=False,
                 pin=False):
        ctx = multiprocessing.get_context(_pick_start_method())
        self._timeout = timeout or None
        self._as_tensor = bool(as_tensor)
        self._pin = bool(pin)
        self._result_queue = ctx.Queue()
        # ONE shared index queue: workers compete for jobs, so a slow
        # sample never head-of-line-blocks batches assigned to one worker
        self._index_queue = ctx.Queue()
        # workers record segment names in b<bidx>-w<wid> files here as they
        # create them, so a worker death never strands segments
        self._reg_dir = tempfile.mkdtemp(prefix="ptdl-reg-")
        self._num_workers = num_workers
        self._workers = []
        self._closed = False
        self._received = set()     # bidx that made it out of result_queue
        self._registered = {}      # bidx -> (wid, [segment names])
        self._reorder = {}
        for wid in range(num_workers):
            w = ctx.Process(
                target=_worker_loop,
                args=(dataset, collate_fn, self._index_queue,
                      self._result_queue, wid, num_workers, worker_init_fn,
                      seed, use_shared_memory, self._reg_dir),
                daemon=True)
            w.start()
            self._workers.append(w)
        self._index_iter = enumerate(index_iter)
        self._next_yield = 0
        self._inflight = 0
        self._depth = max(2, prefetch_factor) * num_workers
        for _ in range(self._depth):
            self._dispatch_one()

    def _dispatch_one(self):
        try:
            bidx, indices = next(self._index_iter)
        except StopIteration:
            return
        self._index_queue.put((bidx, list(indices)))
        self._inflight += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self._inflight == 0:
            self.close()
            raise StopIteration
        deadline = (time.monotonic() + self._timeout) if self._timeout \
            else None
        while self._next_yield not in self._reorder:
            # poll in short slices so that a worker that DIED (no result,
            # no traceback) is noticed instead of blocking on the queue
            poll = 1.0
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0.0:
                    self.close()
                    raise RuntimeError(
                        f"DataLoader timed out after {self._timeout}s "
                        f"waiting for batch {self._next_yield} from "
                        f"workers") from None
                poll = min(poll, remaining)
            try:
                bidx, payload, err = self._result_queue.get(
                    timeout=max(0.01, poll))
            except queue.Empty:
                dead = self._dead_worker()
                if dead is not None:
                    self._abort_for_dead_worker(*dead)  # raises
                continue
            if err is not None:
                self.close()
                raise RuntimeError(f"DataLoader worker failed:\n{err}")
            self._reorder[bidx] = payload
            self._received.add(bidx)
        payload = self._reorder.pop(self._next_yield)
        self._next_yield += 1
        self._inflight -= 1
        self._dispatch_one()
        return _unpack(payload, self._as_tensor, self._pin)

    def _dead_worker(self):
        """(wid, process) of a worker that exited abnormally, else None.
        Exit 0 means the worker consumed its shutdown sentinel."""
        for wid, w in enumerate(self._workers):
            if not w.is_alive() and w.exitcode not in (0, None):
                return wid, w
        return None

    def _load_registry(self):
        """Refresh _registered from the workers' registry files."""
        try:
            entries = os.listdir(self._reg_dir)
        except OSError:
            return
        for fn in entries:
            try:
                bstr, wstr = fn.lstrip("b").split("-w")
                bidx, wid = int(bstr), int(wstr)
                with open(os.path.join(self._reg_dir, fn)) as f:
                    names = [ln.strip() for ln in f if ln.strip()]
            except (ValueError, OSError):  # pragma: no cover
                continue
            self._registered[bidx] = (wid, names)

    @staticmethod
    def _unlink_names(names):
        for name in names:
            try:
                shm = shared_memory.SharedMemory(name=name)
                shm.close()
                shm.unlink()
            except FileNotFoundError:
                pass  # already unlinked through the payload path

    def _abort_for_dead_worker(self, wid, w):
        """A worker died between accepting a job and delivering its result.
        Keep what DID arrive, unlink the segments the dead worker
        registered for batches that never will, then raise."""
        while True:
            try:
                bidx, payload, err = self._result_queue.get_nowait()
            except (queue.Empty, OSError, EOFError):
                break
            if err is None:
                self._reorder[bidx] = payload
            self._received.add(bidx)
        self._load_registry()
        for bidx, (owner, names) in list(self._registered.items()):
            if owner == wid and bidx not in self._received:
                self._unlink_names(names)
                del self._registered[bidx]
        pid, code = w.pid, w.exitcode
        self.close()
        raise DataLoaderWorkerError(
            f"DataLoader worker {wid} (pid {pid}) died with exit code "
            f"{code} before returning batch {self._next_yield}; its "
            f"shared-memory segments were reclaimed")

    def _unlink_payload(self, payload):
        """Release the segments of a batch that will never be consumed."""
        if isinstance(payload, dict):
            for v in payload["__dict__"].values():
                self._unlink_payload(v)
        elif isinstance(payload, (list, tuple)):
            if len(payload) and payload[0] == "__shm__":
                self._unlink_names([payload[1]])
            elif not (len(payload) and payload[0] == "__raw__"):
                for v in payload:
                    self._unlink_payload(v)

    def _drain(self):
        """Release the results produced after the consumer stopped."""
        while True:
            try:
                bidx, payload, err = self._result_queue.get_nowait()
            except Exception:
                break
            self._received.add(bidx)
            if err is None:
                self._unlink_payload(payload)

    def close(self):
        if self._closed:
            return
        self._closed = True
        for _ in range(self._num_workers):
            try:
                self._index_queue.put(None)
            except Exception:  # pragma: no cover
                pass
        # drain before joining: a worker blocked writing a result into a
        # full pipe would not exit
        self._drain()
        for w in self._workers:
            w.join(timeout=2.0)
            if w.is_alive():  # pragma: no cover
                w.terminate()
                w.join(timeout=2.0)
        for payload in self._reorder.values():
            self._unlink_payload(payload)
        self._reorder = {}
        self._drain()
        # registered-but-never-delivered segments (a worker died with its
        # result unflushed, or was terminated above with batches in flight)
        self._load_registry()
        for bidx, (_owner, names) in self._registered.items():
            if bidx not in self._received:
                self._unlink_names(names)
        self._registered = {}
        shutil.rmtree(self._reg_dir, ignore_errors=True)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
