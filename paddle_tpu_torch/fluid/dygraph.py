"""fluid.dygraph, the legacy imperative API (counterpart of
paddle_tpu/fluid/dygraph.py): `guard` turns dygraph on for its scope,
`to_variable` is to_tensor, and the classic layer names are the port's
layers."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..framework import state as _state
from ..framework.state import no_grad  # noqa: F401
from ..framework.tensor import Tensor, to_tensor
from ..nn.layer_base import Layer
from .. import nn as _nn

__all__ = ["guard", "to_variable", "Layer", "no_grad", "Linear",
           "Conv2D", "BatchNorm", "Embedding", "Pool2D", "Dropout",
           "LayerNorm", "enabled"]


@contextlib.contextmanager
def guard(place=None):
    prev = _state.in_static_mode()
    _state.disable_static()
    try:
        yield
    finally:
        if prev:
            _state.enable_static()


def enabled():
    return not _state.in_static_mode()


def to_variable(value, name=None, zero_copy=None, dtype=None):
    """A Tensor of `value` on the current place (a Tensor passes
    through), cast to `dtype` when given."""
    if isinstance(value, Tensor):
        return value
    t = to_tensor(value.detach() if isinstance(value, torch.Tensor)
                  else np.asarray(value))
    if dtype is not None:
        t = t.astype(dtype)
    return t


Linear = _nn.Linear
Conv2D = _nn.Conv2D
BatchNorm = _nn.BatchNorm2D
Embedding = _nn.Embedding
LayerNorm = _nn.LayerNorm
Dropout = _nn.Dropout


class Pool2D(Layer):
    """The classic pooling layer over `layers.pool2d`."""

    def __init__(self, pool_size=2, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, ceil_mode=False):
        super().__init__()
        self._cfg = dict(pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, pool_padding=pool_padding,
                         global_pooling=global_pooling, ceil_mode=ceil_mode)

    def forward(self, x):
        from .layers import pool2d
        return pool2d(x, **self._cfg)
