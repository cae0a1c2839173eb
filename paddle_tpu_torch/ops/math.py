"""Math ops: elementwise, products, reductions, comparisons, search
(counterpart of paddle_tpu/ops/math.py).

Each op is registered under the reference's op type name with the
reference's attrs as keyword arguments, and is a plain function of torch
tensors whose gradient torch autograd gives. Where the two libraries
disagree, the op follows the reference:

* dtypes follow JAX's promotion with 64-bit types on (the reference turns
  `jax_enable_x64` on): a Python float with an integer or bool tensor
  gives float64, an int64 tensor's mean, square root or true division
  float64 and a narrower integer's float32, an integer or bool sum
  int64 (`result_dtype`, `inexact_dtype`);
* gradients at ties and edges are JAX's: `maximum` / `minimum` and
  `clip` split a tie 1/2 and 1/2, `abs` has gradient 1 at 0, the `max` /
  `min` reductions share the gradient among tied maxima, `median` is the
  midpoint of the sorted middle values, `sort` / `topk` / `argsort` are
  stable (a tie keeps the lower index first);
* `nondiff` ops (comparisons, `argmax`, ...) return no gradient;
* ops whose output size depends on values (`nonzero`, `masked_select`,
  `unique`) read the device on the host, so they raise inside a CUDA
  graph capture (`no_capture`) rather than bake one shape into it.

A product the reference computes as an XLA dot is `torch.matmul` /
`torch.einsum` here (cuBLAS): no Pallas kernel sits behind it.
"""
from __future__ import annotations

import builtins
import numbers

import numpy as np
import torch

from ..amp import amp_cast_inputs
from ..framework.dispatch import primitive
from ..framework.dtype import convert_dtype

# ---------------------------------------------------------------------------
# dtype rules (JAX with x64) and argument helpers

_INT64 = (torch.int64,)


def is_floating(dt) -> bool:
    return dt.is_floating_point or dt.is_complex


def inexact_dtype(dt):
    """The float type an op that needs one computes an input of type `dt`
    in (jnp's `to_inexact_dtype` with x64): 64-bit integers -> float64,
    other integers and bool -> float32, floats and complex unchanged."""
    if is_floating(dt):
        return dt
    return torch.float64 if dt in _INT64 else torch.float32


def sum_dtype(dt):
    """The type of a sum or product of `dt` values: int64 for bool and
    integers (JAX's default integer), else `dt`."""
    return torch.int64 if dt == torch.bool or not is_floating(dt) else dt


def _is_number(v) -> bool:
    return isinstance(v, (numbers.Number, np.number)) and not isinstance(
        v, torch.Tensor)


def _scalar_dtype(t_dtype, s):
    """The result type of a tensor of `t_dtype` with the Python number `s`
    (a weak type in JAX)."""
    if isinstance(s, (bool, np.bool_)):
        return t_dtype
    if isinstance(s, (numbers.Integral, np.integer)):
        return torch.int64 if t_dtype == torch.bool else t_dtype
    if isinstance(s, (numbers.Real, np.floating)):
        return t_dtype if is_floating(t_dtype) else torch.float64
    if t_dtype.is_complex:
        return t_dtype
    return torch.complex128 if t_dtype == torch.float64 or not \
        t_dtype.is_floating_point else torch.complex64


def _number_dtype(s):
    if isinstance(s, (bool, np.bool_)):
        return torch.bool
    if isinstance(s, (numbers.Integral, np.integer)):
        return torch.int64
    if isinstance(s, (numbers.Real, np.floating)):
        return torch.float64 if isinstance(s, np.float64) else torch.float32
    return torch.complex64


def as_tensor(v, device=None, dtype=None):
    """`v` as a tensor: tensors pass through (cast to `dtype` if given),
    numpy arrays and Python data become tensors on `device`."""
    if isinstance(v, torch.Tensor):
        return v if dtype is None or v.dtype == dtype else v.to(dtype)
    if _is_number(v):
        dt = dtype or _number_dtype(v)
        return torch.full((), v, dtype=dt, device=device or "cpu")
    t = torch.as_tensor(np.asarray(v), device=device)
    return t if dtype is None else t.to(dtype)


def result_dtype(*args):
    """JAX's result type of tensors and Python numbers (x64 on): the
    tensors' types promoted, then each number's weak type applied."""
    dts = [a.dtype for a in args if isinstance(a, torch.Tensor)]
    if not dts:
        dts = [as_tensor(a).dtype for a in args]
        out = dts[0]
        for d in dts[1:]:
            out = torch.promote_types(out, d)
        return out
    out = dts[0]
    for d in dts[1:]:
        out = torch.promote_types(out, d)
    for a in args:
        if _is_number(a):
            out = _scalar_dtype(out, a)
    return out


def _device_of(*args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def promote(*args, dtype=None):
    """The arguments as tensors of their JAX result type (or `dtype`), on
    the device of the first tensor among them; Python numbers become 0-d
    tensors there."""
    dt = dtype or result_dtype(*args)
    dev = _device_of(*args)
    return [as_tensor(a, dev, dt) for a in args]


def _inexact(*args):
    """promote, then to the inexact type of the result."""
    return promote(*args, dtype=inexact_dtype(result_dtype(*args)))


def no_capture(name):
    """Raise inside a CUDA graph capture: `name`'s output size depends on
    values, which a captured graph cannot hold."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "%s: the output's size depends on the input's values, read on "
            "the host; it cannot run inside a CUDA graph capture "
            "(make_train_step / StepPrograms). Use where / a mask of fixed "
            "shape instead" % name)


def axes_of(axis, ndim):
    """A reduction's axes as a tuple of non-negative ints (every axis for
    None)."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) % max(ndim, 1) for a in axis)
    return (int(axis) % max(ndim, 1),)


# ---------------------------------------------------------------------------
# elementwise binary


@primitive("elementwise_add")
def add(x, y):
    """x + y (op elementwise_add)."""
    x, y = promote(x, y)
    return torch.add(x, y)


@primitive("elementwise_sub")
def subtract(x, y):
    x, y = promote(x, y)
    return torch.sub(x, y)


@primitive("elementwise_mul")
def multiply(x, y):
    x, y = promote(x, y)
    return torch.mul(x, y)


@primitive("elementwise_div")
def divide(x, y):
    """True division: integers divide in their inexact type (int64 /
    int64 is float64, as in the reference)."""
    x, y = _inexact(x, y)
    return torch.div(x, y)


class _FloorDivide(torch.autograd.Function):
    """floor(x / y) whose gradient is 0 in both inputs (jnp.floor_divide's;
    torch's floor_divide has none and raises in a backward)."""

    @staticmethod
    def forward(ctx, x, y):
        return torch.floor_divide(x, y)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), torch.zeros_like(g)


@primitive("elementwise_floordiv")
def floor_divide(x, y):
    x, y = promote(x, y)
    if is_floating(x.dtype) and (x.requires_grad or y.requires_grad):
        return _FloorDivide.apply(x, y)
    return torch.floor_divide(x, y)


@primitive("elementwise_mod")
def remainder(x, y):
    """x mod y with the sign of y (Python's, jnp.mod's)."""
    x, y = promote(x, y)
    return torch.remainder(x, y)


@primitive("elementwise_pow")
def pow_(x, y):
    x, y = promote(x, y)
    return torch.pow(x, y)


@primitive("elementwise_max")
def maximum(x, y):
    """Elementwise max; at a tie each input gets half the gradient."""
    x, y = promote(x, y)
    return torch.maximum(x, y)


@primitive("elementwise_min")
def minimum(x, y):
    x, y = promote(x, y)
    return torch.minimum(x, y)


@primitive("elementwise_fmax")
def fmax(x, y):
    """max ignoring a NaN. jnp.fmax is where(x > y or y is NaN, x, y): at
    a tie y gets the gradient."""
    x, y = promote(x, y)
    return torch.where((x > y) | torch.isnan(y), x, y)


@primitive("elementwise_fmin")
def fmin(x, y):
    x, y = promote(x, y)
    return torch.where((x < y) | torch.isnan(y), x, y)


@primitive("atan2")
def atan2(x, y):
    x, y = _inexact(x, y)
    return torch.atan2(x, y)


# ---------------------------------------------------------------------------
# unary


def _float_in(x):
    """x in its inexact type."""
    return x.to(inexact_dtype(x.dtype)) if not is_floating(x.dtype) else x


@primitive("scale")
def scale(x, *, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return add(multiply(x, scale), bias)
    return multiply(add(x, bias), scale)


@primitive("neg")
def neg(x):
    return torch.neg(x)


@primitive("abs")
def abs_(x):
    """|x|, with gradient 1 at 0 (jnp.abs's), where torch.abs has 0."""
    if x.dtype.is_complex or not is_floating(x.dtype):
        return torch.abs(x)
    return torch.where(x >= 0, x, -x)


@primitive("sign")
def sign(x):
    return torch.sgn(x) if x.dtype.is_complex else torch.sign(x)


def _unary(name, fn):
    """A registered unary op computing `fn` on x in its inexact type."""
    def op(x):
        return fn(_float_in(x))
    op.__name__ = name
    return primitive(name)(op)


def _unary_amp(name, fn):
    """A black-listed unary op: auto_cast gives it float32 inputs."""
    def op(x):
        (x,) = amp_cast_inputs(name, [x])
        return fn(_float_in(x))
    op.__name__ = name
    return primitive(name)(op)


exp = _unary_amp("exp", torch.exp)
log = _unary_amp("log", torch.log)
log2 = _unary_amp("log2", torch.log2)
log10 = _unary_amp("log10", torch.log10)
log1p = _unary_amp("log1p", torch.log1p)
expm1 = _unary("expm1", torch.expm1)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
erf = _unary("erf", torch.special.erf)
erfinv = _unary("erfinv", torch.special.erfinv)
lgamma = _unary("lgamma", torch.lgamma)
digamma = _unary("digamma", torch.special.digamma)
rad2deg = _unary("rad2deg", torch.rad2deg)
deg2rad = _unary("deg2rad", torch.deg2rad)


@primitive("square")
def square(x):
    return torch.square(x) if x.dtype != torch.bool else x.to(torch.int64)


@primitive("reciprocal")
def reciprocal(x):
    return torch.reciprocal(_float_in(x))


def _rounding(name, fn):
    def op(x):
        return fn(x) if is_floating(x.dtype) else x.clone()
    op.__name__ = name
    return primitive(name)(op)


ceil = _rounding("ceil", torch.ceil)
floor = _rounding("floor", torch.floor)
round_ = _rounding("round", torch.round)       # half to even, as jnp.round
trunc = _rounding("trunc", torch.trunc)


@primitive("frac")
def frac(x):
    return x - torch.trunc(x)


@primitive("angle")
def angle(x):
    return torch.angle(_float_in(x))


@primitive("conj")
def conj(x):
    return torch.conj(x).resolve_conj() if x.dtype.is_complex else x.clone()


@primitive("real")
def real(x):
    return torch.real(x).clone() if x.dtype.is_complex else x.clone()


@primitive("imag")
def imag(x):
    return torch.imag(x).clone() if x.dtype.is_complex else \
        torch.zeros_like(x)


@primitive("isnan", nondiff=True)
def isnan(x):
    return torch.isnan(x)


@primitive("isinf", nondiff=True)
def isinf(x):
    return torch.isinf(x)


@primitive("isfinite", nondiff=True)
def isfinite(x):
    return torch.isfinite(x)


def clip_values(x, lo, hi):
    """jnp.clip: minimum(maximum(x, lo), hi), so that x at a bound gets
    half the gradient, as the reference's."""
    if lo is not None:
        x = maximum(x, lo)
    if hi is not None:
        x = minimum(x, hi)
    return x


@primitive("clip")
def clip(x, *, min=None, max=None):  # noqa: A002
    return clip_values(x, min, max)


@primitive("clip_t")
def clip_t(x, min_t, max_t):
    """clip with tensor bounds (reference :297)."""
    return clip_values(x, min_t, max_t)


@primitive("stanh")
def stanh(x, *, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * _float_in(x))


@primitive("logit")
def logit(x, *, eps=None):
    x = _float_in(x)
    if eps is not None:
        x = clip_values(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@primitive("nan_to_num")
def nan_to_num(x, *, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


# ---------------------------------------------------------------------------
# products


@primitive("matmul_v2")
def matmul(x, y, *, transpose_x=False, transpose_y=False):
    """x @ y with the last two axes transposed first where asked (op
    matmul_v2, white-listed under auto_cast)."""
    x, y = amp_cast_inputs("matmul_v2", [x, y])
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    x, y = promote(x, y)
    return torch.matmul(x, y)


@primitive("mul")
def mul_op(x, y, *, x_num_col_dims=1, y_num_col_dims=1):
    """The legacy mul: x flattened to 2-D at x_num_col_dims when it has
    more than two axes, times y (the reference ignores y_num_col_dims)."""
    x, y = amp_cast_inputs("mul", [x, y])
    if x.ndim > 2:
        rows = 1
        for s in x.shape[:x_num_col_dims]:
            rows *= int(s)
        x = x.reshape(rows, -1)
    x, y = promote(x, y)
    return torch.matmul(x, y)


@primitive("dot")
def dot(x, y):
    """sum(x * y) over the last axis."""
    x, y = amp_cast_inputs("dot", [x, y])
    x, y = promote(x, y)
    return torch.sum(x * y, dim=-1, dtype=sum_dtype(x.dtype)
                     if not is_floating(x.dtype) else None)


@primitive("addmm")
def addmm(input, x, y, *, beta=1.0, alpha=1.0):  # noqa: A002
    input, x, y = amp_cast_inputs("addmm", [input, x, y])
    input, x, y = promote(input, x, y)
    return beta * input + alpha * torch.matmul(x, y)


@primitive("outer")
def outer(x, y):
    x, y = promote(x.reshape(-1), y.reshape(-1))
    return torch.outer(x, y)


@primitive("inner")
def inner(x, y):
    x, y = promote(x, y)
    return torch.inner(x, y)


@primitive("cross")
def cross(x, y, *, axis=None):
    x, y = promote(x, y)
    return torch.linalg.cross(x, y, dim=-1 if axis is None else int(axis))


@primitive("bmm")
def bmm(x, y):
    x, y = amp_cast_inputs("bmm", [x, y])
    x, y = promote(x, y)
    return torch.matmul(x, y)


@primitive("mv")
def mv(x, vec):
    x, vec = amp_cast_inputs("mv", [x, vec])
    x, vec = promote(x, vec)
    return torch.matmul(x, vec)


@primitive("kron")
def kron(x, y):
    x, y = promote(x, y)
    return torch.kron(x, y)


# ---------------------------------------------------------------------------
# reductions


@primitive("reduce_sum")
def sum_(x, *, axis=None, keepdim=False, dtype=None):
    """Sum over `axis` (every axis for None); a bool or integer sum is
    int64 unless `dtype` says otherwise."""
    (x,) = amp_cast_inputs("reduce_sum", [x])
    dt = convert_dtype(dtype) if dtype is not None else sum_dtype(x.dtype)
    return torch.sum(x, dim=axes_of(axis, x.ndim), keepdim=keepdim,
                     dtype=dt) if x.ndim else x.to(dt).clone()


@primitive("reduce_mean")
def mean(x, *, axis=None, keepdim=False):
    """Mean over `axis` (every axis for None), in x's inexact type."""
    (x,) = amp_cast_inputs("reduce_mean", [x])
    x = _float_in(x)
    if x.ndim == 0:
        return x.clone()
    return torch.mean(x, dim=axes_of(axis, x.ndim), keepdim=keepdim)


@primitive("reduce_max")
def max_(x, *, axis=None, keepdim=False):
    """Max over `axis`; tied maxima share the gradient equally (jnp.max's
    rule; torch.amax's too)."""
    if x.ndim == 0:
        return x.clone()
    return torch.amax(x, dim=axes_of(axis, x.ndim), keepdim=keepdim)


@primitive("reduce_min")
def min_(x, *, axis=None, keepdim=False):
    if x.ndim == 0:
        return x.clone()
    return torch.amin(x, dim=axes_of(axis, x.ndim), keepdim=keepdim)


@primitive("reduce_prod")
def prod(x, *, axis=None, keepdim=False, dtype=None):
    (x,) = amp_cast_inputs("reduce_prod", [x])
    dt = convert_dtype(dtype) if dtype is not None else sum_dtype(x.dtype)
    out = x.to(dt)
    for a in sorted(axes_of(axis, x.ndim), reverse=True):
        out = torch.prod(out, dim=a, keepdim=keepdim)
    return out if x.ndim else out.clone()


@primitive("reduce_any", nondiff=True)
def any_(x, *, axis=None, keepdim=False):
    if x.ndim == 0:
        return x.to(torch.bool)
    return torch.any(x, dim=axes_of(axis, x.ndim), keepdim=keepdim)


@primitive("reduce_all", nondiff=True)
def all_(x, *, axis=None, keepdim=False):
    if x.ndim == 0:
        return x.to(torch.bool)
    return torch.all(x, dim=axes_of(axis, x.ndim), keepdim=keepdim)


@primitive("logsumexp")
def logsumexp(x, *, axis=None, keepdim=False):
    (x,) = amp_cast_inputs("logsumexp", [x])
    x = _float_in(x)
    if x.ndim == 0:
        return x.clone()
    return torch.logsumexp(x, dim=axes_of(axis, x.ndim), keepdim=keepdim)


@primitive("amax")
def amax(x, *, axis=None, keepdim=False):
    return max_.fn(x, axis=axis, keepdim=keepdim)


@primitive("amin")
def amin(x, *, axis=None, keepdim=False):
    return min_.fn(x, axis=axis, keepdim=keepdim)


@primitive("nanmean")
def nanmean(x, *, axis=None, keepdim=False):
    return torch.nanmean(_float_in(x), dim=axes_of(axis, x.ndim),
                         keepdim=keepdim)


@primitive("nansum")
def nansum(x, *, axis=None, keepdim=False):
    return torch.nansum(x, dim=axes_of(axis, x.ndim), keepdim=keepdim,
                        dtype=sum_dtype(x.dtype))


@primitive("std")
def std(x, *, axis=None, unbiased=True, keepdim=False):
    return torch.std(_float_in(x), dim=axes_of(axis, x.ndim),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@primitive("var")
def var(x, *, axis=None, unbiased=True, keepdim=False):
    return torch.var(_float_in(x), dim=axes_of(axis, x.ndim),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _moved_sorted(x, axis):
    """(x sorted along one axis moved last, the axes reduced): axis None
    flattens; a tuple of axes is merged into one last axis."""
    x = _float_in(x)
    if axis is None:
        return torch.sort(x.reshape(-1), stable=True).values, None
    axes = axes_of(axis, x.ndim)
    rest = [a for a in range(x.ndim) if a not in axes]
    moved = x.permute(rest + list(axes))
    moved = moved.reshape(tuple(moved.shape[:len(rest)]) + (-1,))
    return torch.sort(moved, dim=-1, stable=True).values, axes


def _restore_keepdim(out, x, axes, keepdim):
    """A reduction's output with the reduced axes kept as 1s."""
    if not keepdim:
        return out
    if axes is None:
        return out.reshape((1,) * x.ndim)
    shape = list(x.shape)
    for a in axes:
        shape[a] = 1
    return out.reshape(shape)


def _quantile_sorted(s, q):
    """jnp.quantile(method="linear") of values sorted along the last axis,
    at the float q: interpolation between the two neighbours."""
    n = s.shape[-1]
    pos = q * (n - 1)
    lo = int(np.floor(pos))
    hi = builtins.min(lo + 1, n - 1)
    frac_ = pos - lo
    a = s[..., lo]
    b = s[..., hi]
    return a * (1.0 - frac_) + b * frac_


@primitive("median")
def median(x, *, axis=None, keepdim=False):
    """The median: the mean of the two middle values of an even count
    (torch.median takes the lower one). The gradient goes to those
    values through a stable sort, as jnp.median's."""
    s, axes = _moved_sorted(x, axis)
    n = s.shape[-1]
    out = 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])
    return _restore_keepdim(out, x, axes, keepdim)


@primitive("quantile")
def quantile(x, *, q, axis=None, keepdim=False):
    """The q-quantile by linear interpolation (jnp.quantile's default); a
    list of q gives a leading axis."""
    s, axes = _moved_sorted(x, axis)
    qs = np.asarray(q.tolist() if isinstance(q, torch.Tensor) else q,
                    dtype=np.float64)
    outs = [_restore_keepdim(_quantile_sorted(s, float(qi)), x, axes,
                             keepdim) for qi in qs.reshape(-1)]
    if qs.ndim == 0:
        return outs[0]
    return torch.stack(outs).reshape(qs.shape + tuple(outs[0].shape))


# cumulative


@primitive("cumsum")
def cumsum(x, *, axis=None):
    """Running sum along `axis` (x flattened for None), in x's type (a
    bool's as int64)."""
    (x,) = amp_cast_inputs("cumsum", [x])
    dt = torch.int64 if x.dtype == torch.bool else x.dtype
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=dt)
    return torch.cumsum(x, int(axis), dtype=dt)


@primitive("cumprod")
def cumprod(x, *, dim=None):
    dt = torch.int64 if x.dtype == torch.bool else x.dtype
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0, dtype=dt)
    return torch.cumprod(x, int(dim), dtype=dt)


@primitive("cummax", nondiff=True)
def cummax(x, *, axis=None):
    """(running max, indices). The reference's index output is a
    placeholder of zeros (ops/math.py:458); the port returns the same,
    int64 of x's shape."""
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    vals = torch.cummax(x, int(axis)).values
    return vals, torch.zeros(x.shape, dtype=torch.int64, device=x.device)


@primitive("logcumsumexp")
def logcumsumexp(x, *, axis=None):
    x = _float_in(x)
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return torch.logcumsumexp(x, int(axis))


# ---------------------------------------------------------------------------
# comparison / logical (no gradient)


def _compare(name, fn):
    def op(x, y):
        x, y = promote(x, y)
        return fn(x, y)
    op.__name__ = name
    return primitive(name, nondiff=True)(op)


equal = _compare("equal", torch.eq)
not_equal = _compare("not_equal", torch.ne)
greater_than = _compare("greater_than", torch.gt)
greater_equal = _compare("greater_equal", torch.ge)
less_than = _compare("less_than", torch.lt)
less_equal = _compare("less_equal", torch.le)


def _logical(name, fn):
    def op(x, y):
        x, y = promote(x, y)
        return fn(x, y)
    op.__name__ = name
    return primitive(name, nondiff=True)(op)


logical_and = _logical("logical_and", torch.logical_and)
logical_or = _logical("logical_or", torch.logical_or)
logical_xor = _logical("logical_xor", torch.logical_xor)
bitwise_and = _logical("bitwise_and", torch.bitwise_and)
bitwise_or = _logical("bitwise_or", torch.bitwise_or)
bitwise_xor = _logical("bitwise_xor", torch.bitwise_xor)


@primitive("logical_not", nondiff=True)
def logical_not(x):
    return torch.logical_not(x)


@primitive("bitwise_not", nondiff=True)
def bitwise_not(x):
    return torch.bitwise_not(x)


@primitive("isclose", nondiff=True)
def isclose(x, y, *, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = promote(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


@primitive("allclose", nondiff=True)
def allclose(x, y, *, rtol=1e-05, atol=1e-08, equal_nan=False):
    """A 0-d bool tensor (torch.allclose gives a Python bool)."""
    return isclose.fn(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan).all()


@primitive("equal_all", nondiff=True)
def equal_all(x, y):
    """A 0-d bool tensor: same shape and every element equal."""
    x, y = promote(x, y)
    if tuple(x.shape) != tuple(y.shape):
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.eq(x, y).all()


# ---------------------------------------------------------------------------
# search / index


def _index_out(r, dtype):
    return r.to(convert_dtype(dtype))


@primitive("argmax", nondiff=True)
def argmax(x, *, axis=None, keepdim=False, dtype="int64"):
    """The first index of the max (x flattened for axis None)."""
    if axis is None:
        return _index_out(torch.argmax(x.reshape(-1)), dtype)
    return _index_out(torch.argmax(x, dim=int(axis), keepdim=keepdim), dtype)


@primitive("argmin", nondiff=True)
def argmin(x, *, axis=None, keepdim=False, dtype="int64"):
    if axis is None:
        return _index_out(torch.argmin(x.reshape(-1)), dtype)
    return _index_out(torch.argmin(x, dim=int(axis), keepdim=keepdim), dtype)


def _sort_desc(x, axis):
    """A stable descending sort as jnp.argsort(descending=True) makes it:
    the axis reversed, sorted ascending, reversed back (tied values keep
    their index order)."""
    r = torch.flip(x, (axis,))
    vals, idx = torch.sort(r, dim=axis, stable=True)
    n = x.shape[axis]
    return torch.flip(vals, (axis,)), (n - 1) - torch.flip(idx, (axis,))


@primitive("argsort", nondiff=True)
def argsort(x, *, axis=-1, descending=False):
    """Indices of a stable sort along `axis`."""
    if descending:
        return _sort_desc(x, int(axis))[1].to(torch.int64)
    return torch.sort(x, dim=int(axis), stable=True).indices.to(torch.int64)


@primitive("sort_op")
def sort(x, *, axis=-1, descending=False):
    """A stable sort along `axis`; descending is the ascending sort
    reversed (jnp.sort's: tied values come out last index first, which
    the gradient follows)."""
    out = torch.sort(x, dim=int(axis), stable=True).values
    return torch.flip(out, (int(axis),)) if descending else out


@primitive("top_k_v2")
def topk(x, *, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    """(values, int64 indices) of the k largest (smallest) along `axis`;
    ties keep the lower index first, as lax.top_k."""
    axis = int(axis) % x.ndim
    key = (~x if x.dtype == torch.bool else -x) if largest else x
    idx = torch.sort(key, dim=axis, stable=True).indices.narrow(
        axis, 0, int(k))
    return torch.gather(x, axis, idx), idx.to(torch.int64)


@primitive("where")
def where(cond, x, y):
    x, y = promote(x, y)
    return torch.where(as_tensor(cond, x.device).to(torch.bool), x, y)


@primitive("masked_select")
def masked_select(x, mask):
    """x's elements where mask is true, as a 1-D tensor (its size read on
    the host)."""
    no_capture("masked_select")
    return x[mask.to(torch.bool)]


@primitive("nonzero", nondiff=True)
def nonzero(x, *, as_tuple=False):
    """int64 [N, x.ndim]: the indices of x's non-zero elements."""
    no_capture("nonzero")
    return torch.nonzero(x).to(torch.int64)


@primitive("unique", nondiff=True)
def unique_op(x):
    """The sorted distinct values of x, flattened."""
    no_capture("unique")
    return torch.unique(x.reshape(-1), sorted=True)


# ---------------------------------------------------------------------------
# misc numeric


@primitive("increment")
def increment(x, *, value=1.0):
    return add(x, value)


@primitive("multiplex")
def multiplex(index, *inputs):
    """Row i from inputs[index[i]]."""
    stacked = torch.stack(promote(*inputs), dim=0)
    idx = index.reshape((1, -1) + (1,) * (stacked.ndim - 2)).long()
    idx = idx.expand((1,) + tuple(stacked.shape[1:]))
    return torch.gather(stacked, 0, idx)[0]


@primitive("lerp")
def lerp(x, y, w):
    x, y, w = promote(x, y, w)
    return x + w * (y - x)


@primitive("diff")
def diff(x, *, n=1, axis=-1):
    return torch.diff(x, n=int(n), dim=int(axis))


@primitive("gcd", nondiff=True)
def gcd(x, y):
    x, y = promote(x, y)
    return torch.gcd(x, y)


@primitive("lcm", nondiff=True)
def lcm(x, y):
    x, y = promote(x, y)
    return torch.lcm(x, y)


@primitive("heaviside")
def heaviside(x, y):
    """0 where x < 0, 1 where x > 0, y where x == 0 (the gradient reaches
    y there)."""
    x, y = promote(x, y)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x < 0, zero, torch.where(x > 0, one, y))


@primitive("trapezoid")
def trapezoid(y, *, dx=1.0, axis=-1):
    return torch.trapezoid(_float_in(y), dx=dx, dim=int(axis))


@primitive("identity")
def identity(x):
    """x; what `Program.clone(for_test=True)` turns a dropout into."""
    return x


@primitive("searchsorted_op", nondiff=True)
def searchsorted(sorted_sequence, values, *, right=False, out_int32=False):
    """Insertion indices of `values` into the sorted last axis."""
    s, v = promote(sorted_sequence, values)
    if s.ndim > 1 and v.ndim == 0:
        v = v.reshape(1)
    out = torch.searchsorted(s.contiguous(), v.contiguous(), right=right)
    return out.to(torch.int32 if out_int32 else torch.int64)


@primitive("tensordot_op")
def tensordot(x, y, *, axes=2):
    x, y = promote(x, y)
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(a) if isinstance(a, (list, tuple)) else (a,)
                     for a in axes)
        return torch.tensordot(x, y, dims=(list(axes[0]), list(axes[1])))
    return torch.tensordot(x, y, dims=int(axes))


@primitive("dist_op")
def dist(x, y, *, p=2.0):
    """The p-norm of x - y (broadcast), in the inputs' type (an integer
    difference in float32)."""
    x, y = promote(x, y)
    d = torch.abs(x - y)
    if not is_floating(d.dtype):
        d = d.to(torch.float32)
    if p == float("inf"):
        return torch.amax(d)
    if p == float("-inf"):
        return torch.amin(d)
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    return torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)


@primitive("scale_op")
def scale_op(x, *, scale=1.0, bias=0.0, bias_after_scale=True):
    """scale * x + bias (or scale * (x + bias)): the form
    `paddle.scale` records."""
    if bias_after_scale:
        return add(multiply(scale, x), bias)
    return multiply(scale, add(x, bias))


@primitive("frexp_op")
def frexp(x):
    """(mantissa, exponent): x = mantissa * 2**exponent, mantissa in
    [0.5, 1); the exponent in x's type (reference: ops/misc_ops.py frexp,
    whose gradient passes through the mantissa as 2**-exponent)."""
    x = _float_in(x)
    with torch.no_grad():
        _, e = torch.frexp(x)
    e = e.to(x.dtype)
    return x * torch.pow(2.0, -e), e
