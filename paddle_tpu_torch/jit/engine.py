"""The training and evaluation steps (counterpart of
paddle_tpu/jit/engine.py make_train_step and make_eval_step, minus buffer
donation, the mesh and ZeRO).

Module buffers (a batch norm's running statistics) are held as the
parameters are: the train step's body collects their new values
(`nn.functional.deferred_buffer_updates`) and writes them in place after
the non-finite guard has decided, the old values kept on a skipped step,
as the reference's guard keeps its old buffers; the eval step drops them,
as the reference's eval step does.

The reference compiles forward, loss, backward and the optimizer update
into one XLA executable per input signature (`jax.jit(step_fn,
donate_argnums=...)`, one executable an `_aval_sig`) and passes the
step's per-call state (the RNG key, the step t, lr) as arguments. The
port captures the same sequence once per signature as a CUDA graph and
replays it (`jit/cuda_graph.StepPrograms`, as the serving steps are), and
updates the parameters and moments in place. The per-call state reaches
the kernels through device memory, written by the host before each
replay: the RNG's Philox word (framework/random.py: each dropout draw of
the step reads (seed, base + i) for its index i in the step), the
optimizer's scalar buffer (lr, from a scheduler too, the bias
corrections, the guard's word and the clip's scale, the last two
rewritten on the device inside the graph) and, for the chaos drill's
`nan_at_step`, the step count t. On the CPU
the same bodies run eagerly under the same counters.

Each dispatch is wired as the reference's: `flight.note_dispatch`, a
`StepTelemetry` span ("jit_train" / "jit_eval"; a retrace is a program
build), the memory bank of the first build (its held tensors, and on
CUDA the graphs' pool as temp bytes), `memprof.on_oom` before an OOM
unwinds, `tracing.TRAIN_STEPS`, and, for the train step, the
`StepWatchdog` of FLAGS_step_watchdog_s around the replay and a
synchronize, with the chaos hooks `hang_at_step` and `oom` inside it.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch

from ..framework.device import resolve_device, write_values
from ..framework.flags import flag
from ..framework.random import RNG
from ..framework.selected_rows import dense_gradients
from ..framework.tensor import Tensor
from ..nn.functional import deferred_buffer_updates
from ..observability import flight, memprof, tracing
from ..resilience import chaos
from ..resilience.watchdog import StepWatchdog
from .cuda_graph import StepPrograms

__all__ = ["make_train_step", "TrainStep", "make_eval_step", "EvalStep",
           "all_finite"]


def _signature(tensors):
    """The program key of a batch: each tensor's (shape, dtype), the
    reference's `_aval_sig`."""
    return tuple((tuple(t.shape), str(t.dtype)) for t in tensors)


def all_finite(loss, grads):
    """0-d bool on the device: the loss and every gradient hold no NaN and
    no inf. Exact: a NaN or an inf shows in a tensor's largest magnitude
    (its inf-norm, a max that propagates NaN), and no sum is taken that a
    large finite gradient could overflow. One multi-tensor pass a gradient
    dtype (`torch._foreach_norm` at ord inf), which reads the gradients
    and writes nothing: a few launches for all of them, not one a
    tensor."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    ok = torch.isfinite(loss.detach()).reshape(())
    for group in by_dtype.values():
        peaks = torch._foreach_norm(group, float("inf"))
        ok = ok & torch.isfinite(torch.stack(peaks)).all()
    return ok


class _ProgramStep:
    """What the train and eval steps share: the static buffers of each
    input signature, the `StepPrograms` that build and replay one program
    a signature, and the dispatch's telemetry, memory bank and OOM
    post-mortem. Counters: `compiles` (programs built) and `replays`
    (calls that ran a built program); `telemetry` is the StepTelemetry of
    `engine`."""

    engine = ""

    def __init__(self, network, device):
        self.device = resolve_device(device)
        self.network = network
        for p in network.parameters():
            if p.device.type != self.device.type:
                raise ValueError("parameter on %s, step on %s"
                                 % (p.device, self.device))
        self.programs = StepPrograms(self.device, self._held)
        self.telemetry = tracing.StepTelemetry(self.engine)
        self._static: Dict[tuple, List[torch.Tensor]] = {}
        self._draws: Dict[tuple, int] = {}
        self._banked = False

    def _held(self):
        raise NotImplementedError

    @property
    def compiles(self) -> int:
        return len(self.programs.builds)

    @property
    def replays(self) -> int:
        return sum(self.programs.replays.values())

    def _stage(self, batch):
        """Copy the batch into its signature's static buffers (made at the
        signature's first call), on the compute stream; returns the key."""
        key = _signature(batch)
        static = self._static.get(key)
        if static is None:
            static = self._static[key] = [
                torch.empty(t.shape, dtype=t.dtype, device=self.device)
                for t in batch]
        for s, t in zip(static, batch):
            s.copy_(t, non_blocking=True)
        return key

    def _run(self, key, body):
        """Run the key's program: built at the first call, then replayed.
        A subclass may run `body()` eagerly instead (to hold the programs
        to their bodies)."""
        return self.programs(key, body, self._static[key])

    def _dispatch(self, key, run, step=None):
        """`run()` inside one RNG step and the telemetry span of `key` (a
        miss is the key's program build). An OOM leaves its post-mortem
        (host-side reads and files only) before it unwinds; a failed
        dispatch leaves the RNG where it was, as the reference keeps its
        key. The first program built banks its memory analysis."""
        RNG.begin_step(self.device)
        try:
            with self.telemetry.step(key):
                out = run()
        except Exception as e:
            RNG.end_step(0)
            if memprof.is_oom(e):
                memprof.on_oom(self.engine, e, step=step)
            raise
        RNG.end_step(self._draws.get(key, 0))
        if not self._banked and self.programs.builds:
            self._banked = True
            memprof.bank_executable(self.engine,
                                    self.programs.memory_analysis())
        return out

    def _outlive(self, loss, outs):
        """On CUDA a replay rewrites the graph's outputs: the caller gets
        copies that outlive the next call, as the reference's arrays do."""
        if self.device.type != "cuda":
            return loss, outs
        return (loss.clone() if loss is not None else None,
                [o.clone() for o in outs])

    def __call__(self, inputs: Sequence[torch.Tensor],
                 labels: Sequence[torch.Tensor] = ()):
        """`run`'s loss and outputs as port Tensors (`Tensor.wrap`, a view:
        `numpy()`, `stop_gradient`, ... as the reference's have), made
        outside the program, which holds plain tensors only."""
        loss, outs = self.run(inputs, labels)
        return Tensor.wrap(loss), [Tensor.wrap(o) for o in outs]


class TrainStep(_ProgramStep):
    """call(inputs, labels) -> (loss, outputs) as port Tensors, `run` the
    same as plain tensors; see `make_train_step`.

    Besides `compiles`, `replays`, `programs` and `telemetry`:
    `guard` (FLAGS_skip_nonfinite_steps when the step was made),
    `last_step_skipped` and `skipped_steps` (the guard's skips, kept on
    the device and read when asked)."""

    engine = "jit_train"

    def __init__(self, network, loss_fn, optimizer, device=None):
        super().__init__(network, device)
        self.loss_fn, self.optimizer = loss_fn, optimizer
        self.params = [p for p in network.parameters() if p.requires_grad]
        # read once, when the step is made, as the reference reads them at
        # trace time: a step made with both off captures no extra work
        self.guard = bool(flag("skip_nonfinite_steps"))
        self.nan_step = chaos.nan_at_step()
        self._t = (torch.zeros((), dtype=torch.int64, device=self.device)
                   if self.nan_step is not None else None)
        # the guard's answers, written by the program: the last step
        # skipped, and the skips so far
        self._skip = torch.zeros((), dtype=torch.bool, device=self.device)
        self._skips = torch.zeros((), dtype=torch.int64, device=self.device)

    @property
    def last_step_skipped(self) -> bool:
        """The guard skipped the last step that ran (waits for it)."""
        return self.guard and bool(self._skip)

    @property
    def skipped_steps(self) -> int:
        """Steps the guard skipped (waits for the last one)."""
        return int(self._skips) if self.guard else 0

    def _held(self):
        """The parameters, their moments (made here at the first call,
        before any build), the module buffers, the Philox word, the scalar
        buffer, the guard's answers and, for the NaN drill, the step count
        t."""
        accs = [a for p in self.params
                for a in self.optimizer._get_accumulators(p).values()]
        return (self.params + accs + list(self.network.buffers())
                + [RNG.word(self.device), self.optimizer._scalars,
                   self._skip, self._skips]
                + ([self._t] if self._t is not None else []))

    def _body(self, key, n_inputs):
        """One step on the key's static buffers: forward, loss, backward,
        the guard's test (on the raw gradients), the updates at the staged
        scalars (regularizer, grad clip and rule, the clip's norm taken on
        the device: no host read) and the buffers' new values, each kept
        as it was where the guard said no; every gradient dropped. A
        sparse=True embedding takes the dense gradient here
        (`dense_gradients`), as the reference's traced step does."""
        RNG.rewind_step()
        static = self._static[key]
        with deferred_buffer_updates() as buffer_updates, dense_gradients():
            outputs = self.network(*static[:n_inputs])
            outs = list(outputs) if isinstance(outputs, (list, tuple)) \
                else [outputs]
            loss = self.loss_fn(*outs, *static[n_inputs:])
        if self.nan_step is not None:
            # multiplying (not replacing) poisons the gradients too, as a
            # real divergence propagates backward
            loss = loss * torch.where(self._t == self.nan_step,
                                      float("nan"), 1.0)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.guard:
            ok = all_finite(loss, grads)
            self.optimizer.gate_update(ok)
            torch.logical_not(ok, out=self._skip)
            self._skips.add_(self._skip)
        self.optimizer.apply_updates(list(zip(self.params, grads)))
        with torch.no_grad():
            for buf, new in buffer_updates.values():
                buf.copy_(torch.where(ok, new, buf) if self.guard else new)
        for p in self.params:
            p.grad = None
        self._draws[key] = RNG.step_draws()
        return loss.detach(), [o.detach() for o in outs]

    def _watched_run(self, key, body, step):
        """The chaos hooks, then the program; under the watchdog (with a
        synchronize, so that a hang on the device falls inside its scope)
        when FLAGS_step_watchdog_s > 0."""
        wd_s = float(flag("step_watchdog_s") or 0.0)
        with (StepWatchdog(wd_s, context="compiled train step %d" % step,
                           action=str(flag("step_watchdog_action")))
              if wd_s > 0 else contextlib.nullcontext()):
            chaos.hang_before_dispatch(step)
            chaos.oom_at_dispatch(step)
            out = self._run(key, body)
            if wd_s > 0 and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return out

    def run(self, inputs: Sequence[torch.Tensor],
            labels: Sequence[torch.Tensor]):
        """One step: (loss, outputs) as plain torch tensors (what a caller
        inside the port, such as Model.fit, reads)."""
        if self.optimizer._dygraph_only:
            # the reference's rule raises when its step is traced
            raise NotImplementedError(self.optimizer._captured_error)
        key = self._stage(list(inputs) + list(labels))
        self.optimizer.stage_step()
        step = self.optimizer._step_count
        if self._t is not None:
            write_values(self._t, [step])
        flight.note_dispatch(self.engine, step)
        body = lambda: self._body(key, len(inputs))  # noqa: E731
        loss, outs = self._dispatch(
            key, lambda: self._watched_run(key, body, step), step)
        if tracing.enabled():
            tracing.TRAIN_STEPS.inc()
        return self._outlive(loss, outs)


def make_train_step(network, loss_fn, optimizer, device=None):
    """Returns a `TrainStep`: call(inputs, labels) -> (loss, outputs).

    One call copies the batch into the static buffers of its signature
    (on the compute stream), writes the step's Philox word and stages the
    optimizer's lr and step count, then runs the signature's program: the
    network on `inputs`, `loss_fn(*outputs, *labels)`, `loss.backward()`,
    then `optimizer.apply_updates` over every trainable parameter, which
    updates the parameters and moments IN PLACE under torch.no_grad()
    (the regularizer, then the optimizer's grad_clip over the whole list,
    then the rule, as the reference's step does), writes the module
    buffers' new values (a batch norm's running statistics, computed in
    the forward) in place, and drops every gradient. The step count and
    the lr (a scheduler's current value) are
    taken per call, as the reference takes them (engine.py:286-290): the
    count advances on every call, a skipped or failed one too; the caller
    steps the scheduler. A parameter the loss does
    not reach gets a zero gradient, as in the reference's functional
    grad. On CUDA the program is a CUDA graph captured at the signature's
    first call and replayed after (no eager fallback: a capture or replay
    that fails raises); the returned loss and outputs are copies that
    outlive the next call. Rebinding a parameter (not copying into it)
    makes the next call raise; so does rebinding a buffer.

    The optimizer is any of the port's rules but Dpsgd, whose host-side
    noise draw cannot be captured: a call with it raises
    NotImplementedError, as the reference's does. A parameter's
    optimize_attr["learning_rate"] scales lr for it on the device.

    With FLAGS_skip_nonfinite_steps on when the step is made, the program
    also tests the loss and every gradient for NaN and inf (`all_finite`)
    and gates the update on the answer (`optimizer.gate_update`: every
    rule's guard word), so that
    a non-finite step leaves the parameters and moments as they were, on
    the device, with no copy of them, and the buffers as they were
    (`torch.where(ok, new, old)` copied in place); the program also keeps
    the answer on the device, which `last_step_skipped` and
    `skipped_steps` read when asked, so that the call itself never waits
    for the device.
    PADDLE_TPU_CHAOS's `nan_at_step:K` (also read when the step is made)
    multiplies the loss by NaN at optimizer step K, on the device.

    The DataLoader's device feed allocates each batch on its own copy
    stream, makes the compute stream wait for it and marks it used by the
    compute stream (`record_stream`), so the copy into the static buffers
    reads a batch that has landed and the allocator never hands its block
    to another copy while the step reads it.

    The network's parameters must lie on `device` (default the current
    place: the card unless set_device("cpu"); raises without CUDA)."""
    return TrainStep(network, loss_fn, optimizer, device)


class EvalStep(_ProgramStep):
    """call(inputs, labels=()) -> (loss or None, outputs) as port
    Tensors, `run` the same as plain tensors; see `make_eval_step`."""

    engine = "jit_eval"

    def __init__(self, network, loss_fn=None, device=None):
        super().__init__(network, device)
        self.loss_fn = loss_fn

    def _held(self):
        return (list(self.network.parameters())
                + list(self.network.buffers()) + [RNG.word(self.device)])

    def _body(self, key, n_inputs):
        RNG.rewind_step()
        static = self._static[key]
        # a network in train() mode computes new running statistics; the
        # eval step drops them, as the reference's does
        with torch.no_grad(), deferred_buffer_updates():
            outputs = self.network(*static[:n_inputs])
            outs = list(outputs) if isinstance(outputs, (list, tuple)) \
                else [outputs]
            loss = (self.loss_fn(*outs, *static[n_inputs:])
                    if self.loss_fn is not None else None)
        self._draws[key] = RNG.step_draws()
        return loss, outs

    def run(self, inputs: Sequence[torch.Tensor],
            labels: Sequence[torch.Tensor] = ()):
        """One forward: (loss or None, outputs) as plain torch tensors."""
        key = self._stage(list(inputs) + list(labels))
        body = lambda: self._body(key, len(inputs))  # noqa: E731
        loss, outs = self._dispatch(key, lambda: self._run(key, body))
        return self._outlive(loss, outs)


def make_eval_step(network, loss_fn=None, device=None):
    """Returns an `EvalStep`: call(inputs, labels=()) -> (loss or None,
    outputs), the network's forward and `loss_fn(*outputs, *labels)` when
    a loss is given, under torch.no_grad(), as one program per input
    signature (on CUDA a CUDA graph captured at the signature's first call,
    then replayed). The parameters are not touched. The RNG advances by
    the draws of the network's mode, as the reference's eval step advances
    its key: none in eval mode. The returned loss and outputs outlive the
    next call. The network's parameters must lie on `device`. Module
    buffers are read, never written: a batch norm in train() mode
    normalises by the batch and its running statistics stay as they
    were."""
    return EvalStep(network, loss_fn, device)
