"""Carry weights between the JAX package's model and the port's module.

The port keeps the reference's parameter and buffer names and layouts (a
Linear weight is [in, out] in both, a batch norm's running statistics are
`<layer>._mean` and `<layer>._variance`), so a state dict of numpy arrays
taken from `paddle_tpu_model.state_dict()` maps one to one, and back:

    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    load_reference_state(port_model, state)
    ...
    arrays = export_reference_state(port_model)   # name -> numpy

Both sides list a parameter that is used twice (BERT's word embeddings,
which are also its MLM decoder weight) once, under the name of its first
use, so a tied weight maps one to one.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["load_reference_state", "export_reference_state"]


def _tensors(module):
    """The module's parameters and buffers by name (each once)."""
    out = dict(module.named_parameters())
    out.update(module.named_buffers())
    return out


def load_reference_state(module: torch.nn.Module,
                         state: Mapping[str, np.ndarray]) -> None:
    """Copy every array of `state` into the parameter or buffer of the same
    name, in place, on its device (a built step holds their addresses).
    Raises when a name is missing on either side or a shape differs: a
    silent skip would leave a weight at its random init or a running
    statistic at its start."""
    params = _tensors(module)
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError("state dict does not match the module: missing %s, "
                       "unexpected %s" % (missing, extra))
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(state[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError("%s: shape %s in the state dict, %s in the "
                                 "module" % (name, arr.shape, tuple(p.shape)))
            p.copy_(torch.tensor(arr, dtype=p.dtype))


def export_reference_state(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The way back: every parameter and buffer as a numpy array on the
    host, keyed by the reference's names. numpy has no bfloat16, so a
    bfloat16 tensor comes back as float32 (exactly: bfloat16 widens
    without rounding)."""
    out = {}
    for name, p in _tensors(module).items():
        t = p.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.cpu().numpy().copy()
    return out
