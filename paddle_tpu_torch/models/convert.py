"""Carry weights from the JAX package's model onto the port's module.

The port keeps the reference's parameter names and layouts (a Linear
weight is [in, out] in both), so a state dict of numpy arrays taken from
`paddle_tpu_model.state_dict()` maps one to one:

    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    load_reference_state(port_model, state)
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_reference_state"]


def load_reference_state(module: torch.nn.Module,
                         state: Mapping[str, np.ndarray]) -> None:
    """Copy every array of `state` into the parameter of the same name,
    on the parameter's device. Raises when a name is missing on either
    side or a shape differs: a silent skip would leave a weight at its
    random init."""
    params = dict(module.named_parameters())
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
