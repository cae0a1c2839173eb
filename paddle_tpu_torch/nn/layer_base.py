"""`ParamAttr` and the parameter-creating part of `Layer` (counterpart of
paddle_tpu/nn/layer_base.py:21-49 and `Layer.create_parameter` :128-143).

The port's layers stay `torch.nn.Module`s: `Layer` adds the reference's
methods that torch lacks (below), and `create_parameter`, which reads a
`ParamAttr` as the reference does:
  * `False`: no parameter (None);
  * `initializer`, else the layer's default, else Constant(0) for a bias
    and the global default (XavierNormal) for a weight;
  * `trainable` False: `requires_grad` False, so that neither the
    optimizers nor `make_train_step` update it (the reference's
    stop_gradient);
  * `name`, `learning_rate` (kept as `optimize_attr`, which the
    optimizers read), `regularizer` (used instead of the optimizer's) and
    `need_clip` (read by the gradient clips) as attributes of the
    parameter.
An attr may also be given as a name (str) or an initializer. Parameters
are drawn on the CPU from the caller's `generator`; the model moves the
finished module to its device.

The rest of the reference's `Layer` (paddle_tpu/nn/layer_base.py:49-338)
maps onto the Module: `add_parameter` / `add_sublayer` register,
`sublayers` / `named_sublayers` walk the modules (the layer itself left
out unless asked), `register_forward_post_hook` is torch's forward hook
(hook(layer, inputs, outputs), a non-None result replaces the outputs),
`astype(dtype)` casts the floating parameters and buffers,
`clear_gradients` drops every gradient, `full_name` is the class name in
lower case, and `set_state_dict` (also `set_dict`, `load_dict`) copies a
state dict of the reference's keys (parameters, then buffers such as a
batch norm's `_mean`) into the layer's tensors in place, in their dtype,
and returns (missing keys, unexpected keys); a shape that differs
raises. The state dict itself is torch's, under the same names.
"""
from __future__ import annotations

import torch
from torch import nn

from . import initializer as I
from ..framework.selected_rows import grad_view

__all__ = ["ParamAttr", "Layer"]


class ParamAttr:
    """reference: paddle_tpu/nn/layer_base.py:21."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")


class _Parameter(nn.Parameter):
    """A `torch.nn.Parameter` whose `name` is the ParamAttr's (a torch
    tensor's own `name` is the read-only named-tensor dimension name) and
    whose row-sparse `grad` reads as a SelectedRows."""

    @property
    def grad(self):
        return grad_view(torch.Tensor.grad.__get__(self))

    @grad.setter
    def grad(self, value):
        torch.Tensor.grad.__set__(self, value)

    @property
    def name(self):
        return self.__dict__.get("_name")

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value


class Layer(nn.Module):
    """A `torch.nn.Module` with the reference's methods (see the module's
    docstring)."""

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def named_sublayers(self, prefix="", include_self=False):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    def sublayers(self, include_self=False):
        return [layer for _, layer in self.named_sublayers(
            include_self=include_self)]

    def register_forward_post_hook(self, hook):
        return self.register_forward_hook(hook)

    def astype(self, dtype):
        from ..framework.dtype import convert_dtype
        return self.to(dtype=convert_dtype(dtype))

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def full_name(self):
        return type(self).__name__.lower()

    def set_state_dict(self, state_dict, use_structured_name=True):
        from ..models.convert import set_state_dict
        return set_state_dict(self, state_dict)

    set_dict = set_state_dict
    load_dict = set_state_dict

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, generator=None):
        """A parameter of `shape` as `attr` describes it (see the module's
        docstring), or None for attr False."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = (attr.initializer or default_initializer
                or (I.Constant(0.0) if is_bias else I._GLOBAL_DEFAULT))
        data = init(tuple(int(s) for s in shape), dtype, generator)
        p = _Parameter(data, requires_grad=bool(attr.trainable))
        p.name = attr.name
        p.trainable = bool(attr.trainable)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p
