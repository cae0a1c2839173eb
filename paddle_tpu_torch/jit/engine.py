"""The training step (counterpart of paddle_tpu/jit/engine.py
make_train_step, minus buffer donation, the mesh and ZeRO).

The reference compiles forward, loss, backward and the optimizer update
into one XLA executable per input signature (`jax.jit(step_fn,
donate_argnums=...)`, one executable an `_aval_sig`) and passes the
step's per-call state (the RNG key, the step t, lr) as arguments. The
port captures the same sequence once per signature as a CUDA graph and
replays it (`jit/cuda_graph.StepPrograms`, as the serving steps are), and
updates the parameters and moments in place. The per-call state reaches
the kernels through device memory, written by the host before each
replay: the RNG's Philox word (framework/random.py: each dropout draw of
the step reads (seed, base + i) for its index i in the step) and the
optimizer's scalar buffer (lr and the bias corrections). On the CPU the
same bodies run eagerly under the same counters.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..framework.device import resolve_device
from ..framework.random import RNG
from .cuda_graph import StepPrograms

__all__ = ["make_train_step", "TrainStep"]


def _signature(tensors):
    """The program key of a batch: each tensor's (shape, dtype), the
    reference's `_aval_sig`."""
    return tuple((tuple(t.shape), str(t.dtype)) for t in tensors)


class TrainStep:
    """call(inputs, labels) -> (loss, outputs); see `make_train_step`.

    Counters: `compiles` (programs built, one per input signature) and
    `replays` (calls that ran a built program). `programs` is the
    `StepPrograms` (capture time, launches and the graph pool by key)."""

    def __init__(self, network, loss_fn, optimizer, device="cuda"):
        self.device = resolve_device(device)
        self.network, self.loss_fn, self.optimizer = (network, loss_fn,
                                                      optimizer)
        self.params = [p for p in network.parameters() if p.requires_grad]
        for p in self.params:
            if p.device.type != self.device.type:
                raise ValueError("parameter on %s, train step on %s"
                                 % (p.device, self.device))
        self.programs = StepPrograms(self.device, self._held)
        self._static: Dict[tuple, List[torch.Tensor]] = {}
        self._draws: Dict[tuple, int] = {}

    def _held(self):
        """The parameters, their moments (made here at the first call,
        before any build), the Philox word and the scalar buffer."""
        accs = [a for p in self.params
                for a in self.optimizer._get_accumulators(p).values()]
        return self.params + accs + [RNG.word(self.device),
                                     self.optimizer._scalars]

    @property
    def compiles(self) -> int:
        return len(self.programs.builds)

    @property
    def replays(self) -> int:
        return sum(self.programs.replays.values())

    def _body(self, key, n_inputs):
        """One step on the key's static buffers: forward, loss, backward,
        the updates at the staged scalars; every gradient dropped."""
        RNG.rewind_step()
        static = self._static[key]
        outputs = self.network(*static[:n_inputs])
        outs = list(outputs) if isinstance(outputs, (list, tuple)) \
            else [outputs]
        loss = self.loss_fn(*outs, *static[n_inputs:])
        loss.backward()
        self.optimizer.apply_updates(
            [(p, p.grad if p.grad is not None else torch.zeros_like(p))
             for p in self.params])
        for p in self.params:
            p.grad = None
        self._draws[key] = RNG.step_draws()
        return loss.detach(), [o.detach() for o in outs]

    def _run(self, key, body):
        """Run the key's program: built at the first call, then replayed.
        A subclass may run `body()` eagerly instead (to hold the programs
        to their bodies)."""
        return self.programs(key, body, self._static[key])

    def __call__(self, inputs: Sequence[torch.Tensor],
                 labels: Sequence[torch.Tensor]):
        batch = list(inputs) + list(labels)
        key = _signature(batch)
        static = self._static.get(key)
        if static is None:
            static = self._static[key] = [
                torch.empty(t.shape, dtype=t.dtype, device=self.device)
                for t in batch]
        for s, t in zip(static, batch):
            s.copy_(t, non_blocking=True)
        RNG.begin_step(self.device)
        self.optimizer.stage_step()
        try:
            loss, outs = self._run(key, lambda: self._body(key, len(inputs)))
        finally:
            RNG.end_step(self._draws.get(key, 0))
        if self.device.type == "cuda":
            # a replay rewrites the graph's outputs: the caller's copies
            # outlive the next step, as the reference's arrays do
            loss, outs = loss.clone(), [o.clone() for o in outs]
        return loss, outs


def make_train_step(network, loss_fn, optimizer, device="cuda"):
    """Returns a `TrainStep`: call(inputs, labels) -> (loss, outputs).

    One call copies the batch into the static buffers of its signature
    (on the compute stream), writes the step's Philox word and stages the
    optimizer's lr and step count, then runs the signature's program: the
    network on `inputs`, `loss_fn(*outputs, *labels)`, `loss.backward()`,
    then `optimizer.apply_updates` over every trainable parameter, which
    updates the parameters and moments IN PLACE under torch.no_grad()
    (weight decay regularizer first, as the reference's step does), and
    drops every gradient. The step count and the lr are taken per call,
    as the reference takes them (engine.py:286-290). A parameter the loss
    does not reach gets a zero gradient, as in the reference's functional
    grad. On CUDA the program is a CUDA graph captured at the signature's
    first call and replayed after (no eager fallback: a capture or replay
    that fails raises); the returned loss and outputs are copies that
    outlive the next call. Rebinding a parameter (not copying into it)
    makes the next call raise.

    The DataLoader's device feed allocates each batch on its own copy
    stream, makes the compute stream wait for it and marks it used by the
    compute stream (`record_stream`), so the copy into the static buffers
    reads a batch that has landed and the allocator never hands its block
    to another copy while the step reads it.

    The network's parameters must lie on `device` (default "cuda", which
    raises without CUDA)."""
    return TrainStep(network, loss_fn, optimizer, device)
