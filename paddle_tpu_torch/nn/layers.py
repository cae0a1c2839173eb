"""Layers of the ported paths as torch.nn.Modules (counterparts of
paddle_tpu/nn/layers.py Linear, Embedding, LayerNorm, Dropout, Tanh, and
ResNet's convolutions, batch norms, pools, ReLU, Flatten, Sequential and
CrossEntropyLoss).

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
           "AdaptiveAvgPool2D", "Flatten", "Sequential", "CrossEntropyLoss"]


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
    """The reference's container: layers named "0", "1", ..., or by an
    OrderedDict, or given as (name, layer) pairs."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
        elif layers and all(isinstance(item, tuple) for item in layers):
            super().__init__(collections.OrderedDict(layers))
        else:
            super().__init__(*layers)


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
