"""`backward` and `paddle.grad` (counterpart of
paddle_tpu/framework/autograd.py: `backward` :47, `grad` :360).

The reference keeps a tape of its own; the port has none: both run torch
autograd over the graph torch recorded.
"""
from __future__ import annotations

from typing import Optional

import torch

from .tensor import Tensor

__all__ = ["backward", "grad"]


def _as_list(x):
    if x is None or isinstance(x, torch.Tensor):
        return [x]
    return list(x)


def backward(loss, grad_tensor: Optional[torch.Tensor] = None,
             retain_graph: bool = False):
    """Accumulate d loss / d leaf into every leaf's `grad`; `grad_tensor`
    seeds a non-scalar `loss`. Raises for a loss with
    stop_gradient=True, as the reference does."""
    if not loss.requires_grad:
        raise RuntimeError("backward() on a tensor with stop_gradient=True")
    torch.autograd.backward(loss, grad_tensors=grad_tensor,
                            retain_graph=bool(retain_graph))


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of `outputs` (seeded by `grad_outputs`,
    ones where None) with respect to `inputs`, as a list of Tensors; no
    leaf's `grad` is touched. `create_graph=True` keeps the gradients in
    the graph for a second derivative. `retain_graph=None` keeps the graph,
    as the reference's tape is kept unless `retain_graph=False`. An input
    the outputs do not reach raises unless `allow_unused=True` (then
    None). No gradient flows through a tensor of `no_grad_vars` (the
    reference takes the argument and ignores it)."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    gos = _as_list(grad_outputs) if grad_outputs is not None \
        else [None] * len(outputs)
    if len(gos) != len(outputs):
        raise ValueError("grad: %d grad_outputs for %d outputs"
                         % (len(gos), len(outputs)))
    gos = [torch.ones_like(o) if g is None else g
           for o, g in zip(outputs, gos)]
    keep = True if retain_graph is None else bool(retain_graph)
    hooks = [v.register_hook(torch.zeros_like)
             for v in _as_list(no_grad_vars or []) if v.requires_grad]
    try:
        gs = torch.autograd.grad(outputs, inputs, grad_outputs=gos,
                                 retain_graph=keep or create_graph,
                                 create_graph=bool(create_graph),
                                 allow_unused=True)
    finally:
        for h in hooks:
            h.remove()
    if not allow_unused:
        for i, g in enumerate(gs):
            if g is None:
                raise RuntimeError("grad: input %d is not used in the graph "
                                   "(pass allow_unused=True to get None)"
                                   % i)
    return [Tensor.wrap(g) for g in gs]
