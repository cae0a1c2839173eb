"""The training step (counterpart of paddle_tpu/jit/engine.py
make_train_step, minus jit, buffer donation, the mesh and ZeRO).

The reference compiles forward, loss, backward and the optimizer update
into one XLA executable that returns new parameters and moments. The port
runs the same sequence eagerly and updates the parameters and moments in
place. The serving steps are already captured once as CUDA graphs and
replayed (`jit/cuda_graph.py`, used by inference/serving/engine.py); the
train step is next, once its kernels take their dropout (seed, offset)
and AdamW's lr and bias corrections from device memory.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..framework.device import resolve_device

__all__ = ["make_train_step"]


def make_train_step(network, loss_fn, optimizer, device="cuda"):
    """Returns call(inputs, labels) -> (loss, outputs).

    One call runs the network on `inputs`, `loss_fn(*outputs, *labels)`,
    `loss.backward()`, then `optimizer.apply_gradients` over every
    trainable parameter, which updates the parameters and moments IN
    PLACE under torch.no_grad() (weight decay regularizer first, as the
    reference's step does), and drops every gradient. The step count and
    the lr are taken per call, as the reference takes them
    (engine.py:286-290). A parameter the loss does not reach gets a zero
    gradient, as in the reference's functional grad.

    Dropping a gradient frees its block on the compute stream; the
    DataLoader's device feed allocates each batch on its own copy stream
    and marks it used by the compute stream (`record_stream`), so the
    allocator never hands a block that a step still reads to a copy in
    flight, nor the reverse.

    The network's parameters must lie on `device` (default "cuda", which
    raises without CUDA)."""
    dev = resolve_device(device)
    params = [p for p in network.parameters() if p.requires_grad]
    for p in params:
        if p.device.type != dev.type:
            raise ValueError("parameter on %s, train step on %s"
                             % (p.device, dev))

    def call(inputs: Sequence[torch.Tensor], labels: Sequence[torch.Tensor]):
        outputs = network(*inputs)
        outs = list(outputs) if isinstance(outputs, (list, tuple)) \
            else [outputs]
        loss = loss_fn(*outs, *labels)
        loss.backward()
        optimizer.apply_gradients(
            [(p, p.grad if p.grad is not None else torch.zeros_like(p))
             for p in params])
        for p in params:
            p.grad = None
        return loss.detach(), [o.detach() for o in outs]

    return call
