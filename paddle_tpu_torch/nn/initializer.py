"""Weight initializers (counterpart of paddle_tpu/nn/initializer.py).

Each initializer is called as `init(shape, dtype=None, generator=None)` and
returns a new CPU tensor of `shape` in `dtype` (default: the framework's
default dtype), its random draws taken from `generator` (a CPU
`torch.Generator`; None is torch's default one, which `paddle.seed` seeds).
The fans and limits are the reference's, with paddle's convention that a
2-D weight is [in, out] (a Linear's), so fan_in is shape[0]; a
convolution's [out, in, *kernel] weight has fan_in = in * prod(kernel).
The draws are torch's, so they are not the reference's jax.random values:
only the distributions agree.

A random float32 draw is made directly in float32 (`normal_` / `uniform_`
on a float32 tensor), a float64 one in float64; other floating dtypes draw
in float32 and round once.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.dtype import convert_dtype, get_default_dtype

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Orthogonal", "Dirac", "Assign",
           "calculate_gain", "set_global_initializer"]


def _dtype(dtype):
    return convert_dtype(dtype or get_default_dtype())


def _empty(shape, dtype):
    """An empty CPU tensor to draw into: float64 for float64, else
    float32."""
    return torch.empty(tuple(shape), dtype=torch.float64
                       if dtype == torch.float64 else torch.float32)


class Initializer:
    """reference: nn/initializer.py:17."""

    def __call__(self, shape, dtype=None, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, generator=None):
        return torch.full(tuple(shape), self.value, dtype=_dtype(dtype))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, generator=None):
        dt = _dtype(dtype)
        return _empty(shape, dt).normal_(self.mean, self.std,
                                         generator=generator).to(dt)


class TruncatedNormal(Initializer):
    """mean + std * r, r standard normal truncated to [-2, 2] (the
    reference's jax.random.truncated_normal bounds), drawn by the inverse
    of the normal CDF over a uniform draw."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, generator=None):
        dt = _dtype(dtype)
        lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0)))
                  for b in (-2.0, 2.0))
        u = _empty(shape, dt).uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0,
                                       generator=generator)
        r = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        return (self.mean + self.std * r).to(dt)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, generator=None):
        dt = _dtype(dtype)
        return _empty(shape, dt).uniform_(self.low, self.high,
                                          generator=generator).to(dt)


def _fans(shape):
    """(fan_in, fan_out) as the reference computes them (:60): a 2-D
    weight is [in, out]; a weight of rank > 2 is [out, in, *kernel]."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


class XavierNormal(Initializer):
    """N(0, std), std = gain * sqrt(2 / (fan_in + fan_out)): a Linear's
    default."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def std(self, shape):
        fi, fo = _fans(shape)
        return self.gain * math.sqrt(
            2.0 / ((self.fan_in or fi) + (self.fan_out or fo)))

    def __call__(self, shape, dtype=None, generator=None):
        return Normal(0.0, self.std(shape))(shape, dtype, generator)


class XavierUniform(Initializer):
    """U(-limit, limit), limit = gain * sqrt(6 / (fan_in + fan_out))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def limit(self, shape):
        fi, fo = _fans(shape)
        return self.gain * math.sqrt(
            6.0 / ((self.fan_in or fi) + (self.fan_out or fo)))

    def __call__(self, shape, dtype=None, generator=None):
        lim = self.limit(shape)
        return Uniform(-lim, lim)(shape, dtype, generator)


def _kaiming_gain(nonlinearity, negative_slope):
    """The reference's rule (:104): sqrt(2) for relu, else
    sqrt(2 / (1 + negative_slope^2)) whatever the nonlinearity."""
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    return math.sqrt(2.0 / (1 + negative_slope ** 2))


class KaimingNormal(Initializer):
    """N(0, gain / sqrt(fan_in))."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def std(self, shape):
        fi = self.fan_in or _fans(shape)[0]
        return _kaiming_gain(self.nonlinearity,
                             self.negative_slope) / math.sqrt(fi)

    def __call__(self, shape, dtype=None, generator=None):
        return Normal(0.0, self.std(shape))(shape, dtype, generator)


class KaimingUniform(Initializer):
    """U(-limit, limit), limit = gain * sqrt(3 / fan_in)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def limit(self, shape):
        fi = self.fan_in or _fans(shape)[0]
        return _kaiming_gain(self.nonlinearity,
                             self.negative_slope) * math.sqrt(3.0 / fi)

    def __call__(self, shape, dtype=None, generator=None):
        lim = self.limit(shape)
        return Uniform(-lim, lim)(shape, dtype, generator)


class Orthogonal(Initializer):
    """gain * Q, as jax.nn.initializers.orthogonal builds it (the
    reference's, column axis last): a standard normal [rows, cols] matrix
    with rows = prod(shape[:-1]), cols = shape[-1] (transposed when rows <
    cols), Q of its QR decomposition times the signs of R's diagonal, Q
    transposed back, reshaped to `shape`. Its columns (rows, when rows <
    cols) are orthonormal."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=None, generator=None):
        dt = _dtype(dtype)
        shape = tuple(shape)
        cols = shape[-1]
        rows = int(np.prod(shape)) // cols
        wide = rows < cols
        a = _empty((cols, rows) if wide else (rows, cols), dt).normal_(
            0.0, 1.0, generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if wide:
            q = q.T
        return (self.gain * q).reshape(shape).to(dt)


class Dirac(Initializer):
    """Identity convolution weights [out, in, *kernel]: 1 at the kernel's
    centre of (g * out / groups + i, i), i < min(out / groups, in)."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=None, generator=None):
        w = torch.zeros(tuple(shape), dtype=_dtype(dtype))
        oc, ic = shape[0], shape[1]
        per = oc // self.groups
        centers = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(per, ic)):
                w[(g * per + i, i) + centers] = 1.0
        return w


class Assign(Initializer):
    """The given value (a tensor, a numpy array or nested lists) in
    `dtype`, reshaped to `shape`."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None, generator=None):
        v = self.value
        v = (v.detach().cpu() if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v)))
        return v.to(_dtype(dtype)).reshape(tuple(shape)).clone()


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             "selu": 3.0 / 4}
    return gains[nonlinearity]


# the weight initializer `create_parameter` uses when neither the ParamAttr
# nor the layer names one (reference: :176)
_GLOBAL_DEFAULT = XavierNormal()


def set_global_initializer(weight_init, bias_init=None):
    """Sets the default weight initializer; `bias_init` is taken and not
    used, as in the reference (:180)."""
    global _GLOBAL_DEFAULT
    _GLOBAL_DEFAULT = weight_init
