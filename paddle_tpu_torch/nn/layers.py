"""Layers as torch.nn.Modules (counterparts of paddle_tpu/nn/layers.py:
every layer there, from Linear to HSigmoidLoss). Each is a `Layer`, the
port's `torch.nn.Module` with the reference's methods.

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
           "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm", "MaxPool1D",
           "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "MaxUnPool2D", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
           "Dropout2D", "Dropout3D", "AlphaDropout", "Upsample",
           "UpsamplingNearest2D", "UpsamplingBilinear2D", "PixelShuffle",
           "ChannelShuffle", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
           "Unfold", "Identity", "CosineSimilarity", "PairwiseDistance",
           "Bilinear", "CTCLoss", "HSigmoidLoss",
           "Flatten", "Sequential", "LayerList",
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
    return zeros and pass no gradient to the row. `sparse=True`: in
    dygraph `weight.grad` is a row-sparse SelectedRows (see
    F.embedding)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, generator=None):
        super().__init__()
        self._sparse = bool(sparse)
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
        return F.embedding(ids, self.weight, self._padding_idx,
                           sparse=self._sparse)


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


class Dropout(Layer):
    """paddle's Dropout: live in train(), the mode's eval rule in eval();
    `axis` shares one draw along the other axes (see
    functional.dropout)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode)


class Tanh(Layer):
    def forward(self, x):
        return F.tanh(x)


class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)


class Identity(Layer):
    """x itself (reference: nn/layers.py:44)."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class _ConvNd(Layer):
    """Weight [out, in / groups, *kernel] ([in, out / groups, *kernel] for
    a transposed convolution) and bias [out], both Uniform(-k, k) by
    default, k = 1 / sqrt(in / groups * prod(kernel)) (reference
    nn/layers.py _ConvNd); `weight_attr` / `bias_attr` as in
    `Layer.create_parameter` (bias_attr False: no bias). padding_mode
    other than "zeros" raises (the reference takes it and ignores it)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, weight_attr, bias_attr,
                 data_format, dims, generator, transpose=False,
                 output_padding=0, padding_mode="zeros"):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError("padding_mode %r: zeros only"
                                      % (padding_mode,))
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = F._pair(kernel_size, dims)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        k = 1.0 / math.sqrt(fan_in) if fan_in else 1.0
        wshape = ((in_channels, out_channels // groups) if transpose
                  else (out_channels, in_channels // groups))
        self.weight = self.create_parameter(
            wshape + self._kernel_size, weight_attr,
            default_initializer=I.Uniform(-k, k), generator=generator)
        self.bias = self.create_parameter(
            (out_channels,), bias_attr, is_bias=True,
            default_initializer=I.Uniform(-k, k), generator=generator)

    def forward(self, x):
        return self._conv(x, self.weight, self.bias, self._stride,
                          self._padding, self._dilation, self._groups,
                          self._data_format)


class Conv1D(_ConvNd):
    _conv = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 1, generator,
                         padding_mode=padding_mode)


class Conv2D(_ConvNd):
    _conv = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2, generator,
                         padding_mode=padding_mode)


class Conv3D(_ConvNd):
    _conv = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3, generator,
                         padding_mode=padding_mode)


class _ConvNdTranspose(_ConvNd):
    """A transposed convolution (functional.conv{1,2,3}d_transpose);
    forward's `output_size` picks the output_padding that reaches it."""

    def forward(self, x, output_size=None):
        return self._conv(x, self.weight, self.bias, self._stride,
                          self._padding, self._output_padding,
                          self._dilation, self._groups, self._data_format,
                          output_size=output_size)


class Conv1DTranspose(_ConvNdTranspose):
    _conv = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 1, generator, transpose=True,
                         output_padding=output_padding)


class Conv2DTranspose(_ConvNdTranspose):
    _conv = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2, generator, transpose=True,
                         output_padding=output_padding)


class Conv3DTranspose(_ConvNdTranspose):
    _conv = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3, generator, transpose=True,
                         output_padding=output_padding)


class _BatchNormBase(Layer):
    """weight ones and bias zeros by default (`weight_attr` / `bias_attr`
    as in `Layer.create_parameter`; False: none), the buffers `_mean`
    (zeros) and `_variance` (ones); train() normalises by the batch and
    moves the buffers, eval() by the buffers (functional.batch_norm)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, generator=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            (num_features,), weight_attr,
            default_initializer=I.Constant(1.0), generator=generator)
        self.bias = self.create_parameter((num_features,), bias_attr,
                                          is_bias=True, generator=generator)
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
                 use_global_stats=None, name=None, generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         generator=generator)


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


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics span every rank (reference:
    nn/layers.py:416). On one process it is BatchNorm; the cross-rank
    reduction waits for the distributed port (ROADMAP queue 1, item 5)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every batch norm below it made a SyncBatchNorm of
        the same settings, parameters and statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      weight_attr=False if layer.weight is None else None,
                      bias_attr=False if layer.bias is None else None,
                      data_format=layer._data_format)
            with torch.no_grad():
                for name in ("weight", "bias", "_mean", "_variance"):
                    src = getattr(layer, name)
                    if src is not None:
                        getattr(out, name).copy_(src)
        for name, sub in list(layer._modules.items()):
            if sub is not None:
                out._modules[name] = cls.convert_sync_batchnorm(sub)
        return out


class _Pool(Layer):
    """A pool function with the constructor's options (reference:
    nn/layers.py:238)."""

    def __init__(self, fn, kernel_size, stride, padding, **kw):
        super().__init__()
        self._fn = fn
        self._kernel_size = kernel_size
        self._stride = stride
        self._padding = padding
        self._kw = kw

    def forward(self, x):
        return self._fn(x, self._kernel_size, self._stride, self._padding,
                        **self._kw)


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(F.max_pool1d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode)


class MaxPool2D(_Pool):
    """With return_mask, forward gives (values, flat indices) for
    MaxUnPool2D."""

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(F.max_pool2d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, return_mask=return_mask,
                         data_format=data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(F.max_pool3d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, data_format=data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(F.avg_pool1d, kernel_size, stride, padding,
                         exclusive=exclusive, ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(F.avg_pool2d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, exclusive=exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(F.avg_pool3d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, exclusive=exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)


class _AdaptivePool(Layer):
    def __init__(self, fn, output_size, **kw):
        super().__init__()
        self._fn, self._output_size, self._kw = fn, output_size, kw

    def forward(self, x):
        return self._fn(x, self._output_size, **self._kw)


class AdaptiveAvgPool1D(_AdaptivePool):
    def __init__(self, output_size, name=None):
        super().__init__(F.adaptive_avg_pool1d, output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(F.adaptive_avg_pool2d, output_size,
                         data_format=data_format)


class AdaptiveAvgPool3D(_AdaptivePool):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(F.adaptive_avg_pool3d, output_size,
                         data_format=data_format)


class AdaptiveMaxPool1D(_AdaptivePool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool1d, output_size)


class AdaptiveMaxPool2D(_AdaptivePool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool2d, output_size)


class AdaptiveMaxPool3D(_AdaptivePool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool3d, output_size)


class MaxUnPool2D(Layer):
    """The inverse of MaxPool2D(return_mask=True): forward(x, indices)."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self._cfg = dict(kernel_size=kernel_size, stride=stride,
                         padding=padding, data_format=data_format,
                         output_size=output_size)

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, **self._cfg)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)


class Sequential(Layer, nn.Sequential):
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


class CrossEntropyLoss(Layer):
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


# ---------------------------------------------------------------------------
# the second part of nn (reference: nn/layers.py:464-573, :583-612,
# :671-774, :1018-1102)


class GroupNorm(Layer):
    """F.group_norm over `num_groups` groups of channels, weight ones and
    bias zeros by default (reference: nn/layers.py:464)."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, generator=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            (num_channels,), weight_attr,
            default_initializer=I.Constant(1.0), generator=generator)
        self.bias = self.create_parameter((num_channels,), bias_attr,
                                          is_bias=True, generator=generator)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    """F.instance_norm with the parameters `scale` (ones) and `bias`
    (zeros), the reference's names (nn/layers.py:483)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, generator=None):
        super().__init__()
        self._epsilon = epsilon
        self.scale = self.create_parameter(
            (num_features,), weight_attr,
            default_initializer=I.Constant(1.0), generator=generator)
        self.bias = self.create_parameter((num_features,), bias_attr,
                                          is_bias=True, generator=generator)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


class SpectralNorm(Layer):
    """weight / sigma, sigma its largest singular value by power iteration
    over the weight reshaped to [shape[dim], -1] (reference:
    nn/layers.py:529). `weight_u` [h] and `weight_v` [w] are parameters
    that take no gradient (N(0, 1) at first), moved by each forward's
    `power_iters` steps; sigma = u . (W v) with u and v held constant, so
    the gradient reaches the weight through W / sigma, as in paddle (the
    reference's eager forward returns a new leaf with no gradient path,
    its traced one also differentiates through the iteration)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", generator=None):
        super().__init__()
        from .layer_base import ParamAttr
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        fixed = ParamAttr(trainable=False)
        self.weight_u = self.create_parameter(
            (h,), fixed, default_initializer=I.Normal(0.0, 1.0),
            generator=generator)
        self.weight_v = self.create_parameter(
            (w,), fixed, default_initializer=I.Normal(0.0, 1.0),
            generator=generator)

    def forward(self, weight):
        w = weight.movedim(self._dim, 0) if self._dim != 0 else weight
        wm = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            u, v = self.weight_u.detach(), self.weight_v.detach()
            wd = wm.detach()
            for _ in range(self._power_iters):
                v = wd.t() @ u
                v = v / (torch.linalg.vector_norm(v) + self._eps)
                u = wd @ v
                u = u / (torch.linalg.vector_norm(u) + self._eps)
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        out = w / (u @ (wm @ v))
        return out.movedim(0, self._dim) if self._dim != 0 else out


class Dropout2D(Layer):
    """Whole channels dropped (functional.dropout2d)."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self._df = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self._df)


class Dropout3D(Layer):
    """Whole channels dropped (functional.dropout3d)."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self._df = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self._df)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training)


class Upsample(Layer):
    """F.interpolate with the constructor's options."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self._kw = dict(size=size, scale_factor=scale_factor, mode=mode,
                        align_corners=align_corners, align_mode=align_mode,
                        data_format=data_format)

    def forward(self, x):
        return F.interpolate(x, **self._kw)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with align_corners, as the reference's."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._r, self._df = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self._r, self._df)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self._g, self._df = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self._g, self._df)


class _PadN(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._padding = padding
        self._mode = mode
        self._value = value
        self._df = data_format

    def forward(self, x):
        return F.pad(x, self._padding, self._mode, self._value, self._df)


class Pad1D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadN):
    pass


class Pad3D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Layer):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        self._padding, self._df = padding, data_format

    def forward(self, x):
        return F.zeropad2d(x, self._padding, self._df)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self._axis, self._eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self._axis, self._eps)


class PairwiseDistance(Layer):
    """||x - y + epsilon||_p along the last axis (reference:
    nn/layers.py:1050)."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = float(p)
        self.epsilon = float(epsilon)
        self.keepdim = keepdim

    def forward(self, x, y):
        from ..tensor import norm
        return norm(x - y + self.epsilon, p=self.p, axis=-1,
                    keepdim=self.keepdim)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self._kw = dict(kernel_sizes=kernel_sizes, strides=strides,
                        paddings=paddings, dilations=dilations)

    def forward(self, x):
        return F.unfold(x, **self._kw)


class Bilinear(Layer):
    """x1ᵀ W x2 + b, weight [out, in1, in2] (XavierNormal by default) and
    bias [out] (reference: nn/layers.py:1033)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None,
                 generator=None):
        super().__init__()
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), weight_attr,
            generator=generator)
        self.bias = self.create_parameter((out_features,), bias_attr,
                                          is_bias=True, generator=generator)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class HSigmoidLoss(Layer):
    """The hierarchical sigmoid loss with its node weights [rows,
    feature_size] and bias [rows, 1], rows num_classes - 1 for the default
    tree, num_classes for a custom one (reference: nn/layers.py:1080)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, generator=None):
        super().__init__()
        if not is_custom and num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self._num_classes = num_classes
        rows = num_classes if is_custom else num_classes - 1
        self.weight = self.create_parameter((rows, feature_size),
                                            weight_attr, generator=generator)
        self.bias = self.create_parameter((rows, 1), bias_attr, is_bias=True,
                                          generator=generator)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self._num_classes, self.weight,
                               self.bias, path_table, path_code)
