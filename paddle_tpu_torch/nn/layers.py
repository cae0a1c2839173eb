"""Layers as torch.nn.Modules (counterparts of paddle_tpu/nn/layers.py
Linear, Embedding, LayerNorm, Dropout, ResNet's convolutions, batch norms,
pools and Flatten, the containers, the activation layers and the losses).

Parameters are created on the CPU and drawn from the explicit
`torch.Generator` the caller passes; the model factory moves the finished
module to its device. A `Linear` weight is [in, out] and a convolution's
OIHW, as in paddle; a batch norm's running statistics are the module
buffers `_mean` and `_variance`, under the reference's names.
"""
from __future__ import annotations

import collections
import math

import numpy as np
import torch
from torch import nn

from . import functional as F
from . import initializer as I
from .layer_base import Layer
from ..tensor import flatten

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout", "Tanh", "ReLU",
           "Conv1D", "Conv2D", "Conv3D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "MaxPool2D", "AvgPool2D",
           "AdaptiveAvgPool2D", "Flatten", "Sequential", "LayerList",
           "LayerDict", "ParameterList", "ReLU6", "LeakyReLU", "PReLU",
           "ELU", "SELU", "CELU", "GELU", "Sigmoid", "Silu", "Swish",
           "Tanhshrink", "Hardtanh", "Hardshrink", "Softshrink",
           "Hardsigmoid", "Hardswish", "Mish", "Softplus", "Softsign",
           "LogSigmoid", "Softmax", "LogSoftmax", "Maxout",
           "ThresholdedReLU", "GLU", "CrossEntropyLoss", "MSELoss",
           "L1Loss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "KLDivLoss",
           "SmoothL1Loss", "MarginRankingLoss", "HingeEmbeddingLoss"]


class Linear(Layer):
    """y = x @ weight + bias, weight [in, out] (reference: nn/layers.py:46):
    by default XavierNormal weights and a zero bias; `weight_attr` /
    `bias_attr` as in `Layer.create_parameter` (bias_attr False: no
    bias)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), weight_attr,
            default_initializer=I.XavierNormal(), generator=generator)
        self.bias = self.create_parameter((out_features,), bias_attr,
                                          is_bias=True, generator=generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    """Row lookup in weight [num_embeddings, embedding_dim] (reference:
    nn/layers.py:74), N(0, 1) by default. `padding_idx` (negative counts
    from the end) names a row that is zeroed after the draw, whose lookups
    return zeros and pass no gradient to the row."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, generator=None):
        super().__init__()
        if sparse:
            raise NotImplementedError("Embedding(sparse=True): row-sparse "
                                      "gradients are not ported")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (None if padding_idx is None else
                             padding_idx if padding_idx >= 0
                             else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), weight_attr,
            default_initializer=I.Normal(0.0, 1.0), generator=generator)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, ids):
        return F.embedding(ids, self.weight, self._padding_idx)


class LayerNorm(Layer):
    """LayerNorm over the last axis (reference: nn/layers.py:439): weight
    ones and bias zeros by default; weight_attr / bias_attr False: none."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, generator=None):
        super().__init__()
        self._epsilon = epsilon
        shape = ((normalized_shape,) if isinstance(normalized_shape, int)
                 else tuple(normalized_shape))
        self.weight = self.create_parameter(
            shape, weight_attr, default_initializer=I.Constant(1.0),
            generator=generator)
        self.bias = self.create_parameter(shape, bias_attr, is_bias=True,
                                          generator=generator)

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self._epsilon)


class Dropout(nn.Module):
    """paddle's Dropout: live in train(), the mode's eval rule in eval()
    (see functional.dropout)."""

    def __init__(self, p=0.5, mode="upscale_in_train"):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.mode)


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


def _uniform(shape, bound, generator):
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class _ConvNd(nn.Module):
    """Weight [out, in / groups, *kernel] and bias [out] drawn from
    Uniform(-k, k), k = 1 / sqrt(fan_in) (reference nn/layers.py _ConvNd);
    bias_attr=False: no bias. Only the default attrs (or False) are
    taken."""

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, bias_attr, data_format, dims,
                 generator):
        super().__init__()
        if bias_attr not in (None, False):
            raise ValueError("bias_attr: None or False")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = F._pair(kernel_size, dims)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        k = 1.0 / math.sqrt(fan_in) if fan_in else 1.0
        self.weight = nn.Parameter(_uniform(
            (out_channels, in_channels // groups) + self._kernel_size, k,
            generator))
        self.bias = (None if bias_attr is False
                     else nn.Parameter(_uniform((out_channels,), k,
                                                generator)))

    def forward(self, x):
        return self._conv(x, self.weight, self.bias, self._stride,
                          self._padding, self._dilation, self._groups,
                          self._data_format)


class Conv1D(_ConvNd):
    _conv = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 data_format="NCL", generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, data_format,
                         1, generator)


class Conv2D(_ConvNd):
    _conv = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 data_format="NCHW", generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, data_format,
                         2, generator)


class Conv3D(_ConvNd):
    _conv = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 data_format="NCDHW", generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, data_format,
                         3, generator)


class _BatchNormBase(nn.Module):
    """weight ones and bias zeros (weight_attr / bias_attr False: none),
    the buffers `_mean` (zeros) and `_variance` (ones); train() normalises
    by the batch and moves the buffers, eval() by the buffers
    (functional.batch_norm)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None):
        super().__init__()
        for attr in (weight_attr, bias_attr):
            if attr not in (None, False):
                raise ValueError("weight_attr / bias_attr: None or False")
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = (None if weight_attr is False
                       else nn.Parameter(torch.ones(num_features)))
        self.bias = (None if bias_attr is False
                     else nn.Parameter(torch.zeros(num_features)))
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm(_BatchNormBase):
    """The legacy fluid.dygraph.BatchNorm signature, with its `act`."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None)
        self._act = act

    def forward(self, x):
        y = super().forward(x)
        return getattr(F, self._act)(y) if self._act else y


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format="NCHW"):
        super().__init__()
        self._args = (kernel_size, stride, padding, ceil_mode, data_format)

    def forward(self, x):
        return F.max_pool2d(x, *self._args)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, data_format="NCHW"):
        super().__init__()
        self._args = (kernel_size, stride, padding, ceil_mode, exclusive,
                      data_format)

    def forward(self, x):
        return F.avg_pool2d(x, *self._args)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size, self._data_format)


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)


class Sequential(nn.Sequential):
    """The reference's container (nn/layers.py:776): layers named "0",
    "1", ... by position, or by an OrderedDict, or given as (name, layer)
    pairs (mixed with plain layers, which keep their position's name); a
    slice is a new Sequential of those layers named from "0" again, as
    the reference's is."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_module(name, layer)
        else:
            for i, item in enumerate(layers):
                if isinstance(item, tuple):
                    self.add_module(item[0], item[1])
                else:
                    self.add_module(str(i), item)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)


class LayerList(Layer, nn.ModuleList):
    """The reference's LayerList (nn/layers.py:807): sublayers named "0",
    "1", ... (a slice is a new LayerList named from "0"; insert renames);
    append and extend return the list."""


class LayerDict(Layer, nn.ModuleDict):
    """The reference's LayerDict (nn/layers.py:847): sublayers by key,
    in insertion order; `update` takes a dict or (key, layer) pairs."""


class ParameterList(Layer, nn.ParameterList):
    """The reference's ParameterList (nn/layers.py:894): parameters named
    "0", "1", ...; append returns the list."""


def _act_layer(name, fn, doc):
    """An activation layer as the reference's `_act_layer` makes it
    (nn/layers.py:614): the constructor's arguments are passed to `fn`
    after x."""
    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        self._args = args
        self._kwargs = kwargs

    def forward(self, x):
        return fn(x, *self._args, **self._kwargs)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__doc__": doc, "__module__": __name__})


ReLU6 = _act_layer("ReLU6", lambda x, name=None: F.relu6(x), "F.relu6")
LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu, "F.leaky_relu")
ELU = _act_layer("ELU", F.elu, "F.elu")
# the reference's SELU takes scale and alpha and computes the default
# selu (nn/layers.py:627); so does the port's
SELU = _act_layer("SELU", lambda x, *a, name=None: F.selu(x), "F.selu")
CELU = _act_layer("CELU", F.celu, "F.celu")
GELU = _act_layer("GELU", F.gelu, "F.gelu")
Sigmoid = _act_layer("Sigmoid", lambda x, name=None: F.sigmoid(x),
                     "F.sigmoid")
Silu = _act_layer("Silu", lambda x, name=None: F.silu(x), "F.silu")
Swish = _act_layer("Swish", lambda x, name=None: F.swish(x), "F.swish")
Tanhshrink = _act_layer("Tanhshrink", lambda x, name=None: F.tanhshrink(x),
                        "F.tanhshrink")
Hardtanh = _act_layer("Hardtanh", F.hardtanh, "F.hardtanh")
Hardshrink = _act_layer("Hardshrink", F.hardshrink, "F.hardshrink")
Softshrink = _act_layer("Softshrink", F.softshrink, "F.softshrink")
Hardsigmoid = _act_layer("Hardsigmoid",
                         lambda x, name=None: F.hardsigmoid(x),
                         "F.hardsigmoid")
Hardswish = _act_layer("Hardswish", lambda x, name=None: F.hardswish(x),
                       "F.hardswish")
Mish = _act_layer("Mish", lambda x, name=None: F.mish(x), "F.mish")
Softplus = _act_layer("Softplus", F.softplus, "F.softplus")
Softsign = _act_layer("Softsign", lambda x, name=None: F.softsign(x),
                      "F.softsign")
LogSigmoid = _act_layer("LogSigmoid", lambda x, name=None: F.log_sigmoid(x),
                        "F.log_sigmoid")
Softmax = _act_layer("Softmax", F.softmax, "F.softmax")
LogSoftmax = _act_layer("LogSoftmax", F.log_softmax, "F.log_softmax")
Maxout = _act_layer("Maxout", F.maxout, "F.maxout")
ThresholdedReLU = _act_layer("ThresholdedReLU", F.thresholded_relu,
                             "F.thresholded_relu")
GLU = _act_layer("GLU", F.glu, "F.glu")


class PReLU(Layer):
    """F.prelu with a learned weight of `num_parameters` slopes, `init`
    each (reference: nn/layers.py:654)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, generator=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), weight_attr,
            default_initializer=I.Constant(init), generator=generator)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class CrossEntropyLoss(nn.Module):
    """functional.cross_entropy as a layer (reference: nn/layers.py:929),
    with every option of the reference's."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self._kw = dict(weight=weight, ignore_index=ignore_index,
                        reduction=reduction, soft_label=soft_label,
                        axis=axis, use_softmax=use_softmax)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self._kw)



class _Loss(Layer):
    """A loss function as a layer: forward(input, label) calls `fn` with
    the constructor's options (reference: nn/layers.py:919)."""

    def __init__(self, fn, **kw):
        super().__init__()
        self._fn = fn
        self._kw = kw

    def forward(self, input, label):
        return self._fn(input, label, **self._kw)


class MSELoss(_Loss):
    def __init__(self, reduction="mean"):
        super().__init__(F.mse_loss, reduction=reduction)


class L1Loss(_Loss):
    def __init__(self, reduction="mean", name=None):
        super().__init__(F.l1_loss, reduction=reduction)


class NLLLoss(_Loss):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__(F.nll_loss, weight=weight,
                         ignore_index=ignore_index, reduction=reduction)


class BCELoss(_Loss):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(F.binary_cross_entropy, weight=weight,
                         reduction=reduction)


class BCEWithLogitsLoss(_Loss):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(F.binary_cross_entropy_with_logits, weight=weight,
                         reduction=reduction, pos_weight=pos_weight)


class KLDivLoss(_Loss):
    def __init__(self, reduction="mean"):
        super().__init__(F.kl_div, reduction=reduction)


class SmoothL1Loss(_Loss):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(F.smooth_l1_loss, reduction=reduction, delta=delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self._margin,
                                     self._reduction)


class HingeEmbeddingLoss(_Loss):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(F.hinge_embedding_loss, margin=margin,
                         reduction=reduction)
