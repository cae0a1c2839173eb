"""Compile-once step programs (the port's counterpart of
`jax.jit(fn, donate_argnums=...)` as the reference's engines use it).

A `StepPrograms` keeps one program per key. `programs(key, body)` builds
the key's program on its first call and runs it on every later one:

  * on CUDA the first call runs `body()` eagerly on a side stream, which
    gives the real result and is the warm-up a capture needs (module
    loading, cuBLAS's workspace for that stream, the kernels'
    shared-memory opt-in), then captures `body()` into a CUDA graph on the
    same stream, in one memory pool that all of this object's graphs
    share; capture records work but runs none, so the state is not
    advanced twice. Every later call replays the graph on the current
    stream;
  * on the CPU every call runs `body()` eagerly, under the same counters.

A body takes no arguments. It reads and writes tensors that outlive the
program (the caller's static buffers, which the host fills before a call,
and the model's weights) and may return a result: a call returns the
build's eager result, then, on each replay, the result of the capture run,
whose tensors the replay has just rewritten in the graph's pool. Such a
result is valid until the next call of any program of this object: a
caller that keeps it copies it out (the train step clones its loss and
outputs). The serving bodies return nothing and write only static
buffers. Either way one pool serves every program in any order, one at a
time on one stream. A body may allocate inside the capture, as the train
step's backward allocates its gradients: the pool keeps those blocks for
the graph.

What a program freezes at its build, as a trace does: the flags (on the
CPU each later call runs under the flags of the build) and the addresses
of the tensors it holds. Every call checks that `held()` still gives the
addresses of the first build, and that the key's own `buffers` (a call's
static inputs) give those of its build, and raises RuntimeError if one
moved: a weight loaded with `copy_` is seen by the next replay, a rebound
one would not be. There is no eager fallback and no switch: a capture or
a replay that fails raises.

Launch accounting: a capture's kernel launches ran nothing, so they are
taken back out of `ops.cuda_kernels.launch_counts()` and kept as the
program's `launches`; each replay adds them again. The attention path
counts (`attention_path_counts()`) count bodies that ran in Python, the
eager build run and the capture, never a replay, as the reference's count
rises at trace time.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, Iterable

import torch

from ..framework import flags
from ..observability import memprof
from ..ops import cuda_kernels as ck

__all__ = ["StepPrograms"]


class StepPrograms:
    """Keyed step programs on `device`; `held()` lists the tensors whose
    addresses the programs keep (weights, buffers, caches).

    Counters, by key: `builds` (1 once built), `replays` (calls after the
    build), `launches` (kernel launches of one run), `capture_s` (seconds
    of the capture on CUDA, 0.0 on the CPU)."""

    def __init__(self, device, held: Callable[[], Iterable[torch.Tensor]]):
        self.device = torch.device(device)
        self._held = held
        self._addresses = None
        self._graphs: Dict[Hashable, torch.cuda.CUDAGraph] = {}
        self._flags: Dict[Hashable, dict] = {}
        self._results: Dict[Hashable, Any] = {}
        self._buffers: Dict[Hashable, tuple] = {}
        self.builds: Dict[Hashable, int] = {}
        self.replays: Dict[Hashable, int] = {}
        self.launches: Dict[Hashable, Dict[str, int]] = {}
        self.capture_s: Dict[Hashable, float] = {}
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self.pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        else:
            self.pool = self._stream = None

    def __call__(self, key: Hashable, body: Callable[[], Any],
                 buffers: Iterable[torch.Tensor] = ()) -> Any:
        """Build or replay the key's program; returns the body's result
        (see the module's note). `buffers`: tensors of this key alone that
        the program holds (its static inputs)."""
        addresses = tuple(t.data_ptr() for t in self._held())
        if self._addresses is None:
            self._addresses = addresses
        own = tuple(t.data_ptr() for t in buffers)
        if addresses != self._addresses or own != self._buffers.get(key,
                                                                    own):
            raise RuntimeError(
                "a tensor held by the step programs moved since they were "
                "built (a parameter or buffer rebound, not copied into); "
                "build a new engine or train step")
        if key not in self.builds:
            self._buffers[key] = own
            return self._build(key, body)
        self.replays[key] += 1
        if self._cuda:
            self._graphs[key].replay()
            ck.add_launches(self.launches[key])
            return self._results[key]
        with flags.flags_as(self._flags[key]):
            return body()

    def _build(self, key, body):
        before = ck.launch_counts()
        if self._cuda:
            # the eager run goes on the capture stream, so that what cuBLAS
            # and CUDA set up per stream (a workspace, a kernel's first
            # load) is in place before the capture
            current = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                result = body()
            current.wait_stream(self._stream)
        else:
            result = body()
        eager = ck.launch_delta(before)
        capture_s = 0.0
        if self._cuda:
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            mark = ck.launch_counts()
            # thread_local: a thread of another component (a DataLoader's
            # copy stream) may allocate while this thread captures
            with torch.cuda.graph(graph, pool=self.pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                self._results[key] = body()
            captured = ck.launch_delta(mark)
            ck.add_launches(captured, -1)
            capture_s = time.perf_counter() - t0
            if captured != eager:
                raise RuntimeError(
                    "program %r captured other launches (%s) than its eager "
                    "run (%s): its body branches on something other than "
                    "its inputs' shapes" % (key, captured, eager))
            self._graphs[key] = graph
        self._flags[key] = flags.all_flags()
        self.launches[key] = eager
        self.capture_s[key] = capture_s
        self.builds[key] = 1
        self.replays[key] = 0
        return result

    def runs(self, key) -> int:
        """Times the key's program ran: its build and its replays."""
        return self.builds.get(key, 0) + self.replays.get(key, 0)

    def memory_analysis(self) -> dict:
        """memprof's analysis of these programs: the held tensors as
        argument bytes and, on CUDA, the graphs' pool as temp bytes
        (source "cuda_graph"; "avals" on the CPU)."""
        analysis = memprof.analysis_from_arrays(list(self._held()))
        if self._cuda:
            pool = self.pool_bytes()
            analysis.update(source="cuda_graph", temp_bytes=pool,
                            total_bytes=analysis["total_bytes"] + pool)
        return analysis

    def pool_bytes(self):
        """Bytes of device memory in the graphs' pool (the allocator's
        segments of that pool), None on the CPU."""
        if not self._cuda:
            return None
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
