"""The tensor-op surface (counterpart of paddle_tpu/tensor/__init__.py,
tensor/math.py and tensor/manipulation.py): every function the
reference's `paddle.tensor` exports, bound at the top level of the
package by `from .tensor import *`.

The ops live in ops/math.py, ops/manipulation.py, ops/creation.py,
ops/linalg.py and ops/random_ops.py, each registered under the
reference's op type name. The reference's primitives take their attrs as
keywords; the functions here take the reference's Python signatures,
positional axes included (`paddle.sum(x, 1)`, `paddle.mean(x, 1, True)`).

Tensor methods: the port's `Tensor` is a `torch.Tensor` whose op results
are plain torch tensors. It gains the reference's method names that torch
lacks (`mod`, `greater_than`, `equal_all`, `gather_nd`, ...), with the
reference's meaning. A name torch already defines with another meaning
keeps torch's (`transpose(d0, d1)`, `split(size)`, `max(dim)`,
`gather(dim, index)`, `scatter`, `expand(*sizes)`, `sort`, `unique`,
`norm`, `std` / `var`, `equal`, `histogram`, `kthvalue`, ...): the port's
own modules call those methods on the tensors users hand in. The
functions here always have the reference's meaning.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from ..ops import creation as _c
from ..ops import linalg as _la
from ..ops import manipulation as _mp
from ..ops import math as _m
from ..ops import random_ops as _r

# ---- math -----------------------------------------------------------------
add = _m.add
subtract = _m.subtract
multiply = _m.multiply
divide = _m.divide
floor_divide = _m.floor_divide
remainder = _m.remainder
mod = _m.remainder
floor_mod = _m.remainder
maximum = _m.maximum
minimum = _m.minimum
fmax = _m.fmax
fmin = _m.fmin
atan2 = _m.atan2
neg = _m.neg
abs = _m.abs_  # noqa: A001
sign = _m.sign
exp = _m.exp
expm1 = _m.expm1
log = _m.log
log2 = _m.log2
log10 = _m.log10
log1p = _m.log1p
frexp = _m.frexp
sqrt = _m.sqrt
rsqrt = _m.rsqrt
square = _m.square
reciprocal = _m.reciprocal
sin = _m.sin
cos = _m.cos
tan = _m.tan
asin = _m.asin
acos = _m.acos
atan = _m.atan
sinh = _m.sinh
cosh = _m.cosh
asinh = _m.asinh
acosh = _m.acosh
atanh = _m.atanh
ceil = _m.ceil
floor = _m.floor
round = _m.round_  # noqa: A001
trunc = _m.trunc
frac = _m.frac
erf = _m.erf
erfinv = _m.erfinv
lgamma = _m.lgamma
digamma = _m.digamma
angle = _m.angle
conj = _m.conj
real = _m.real
imag = _m.imag
isnan = _m.isnan
isinf = _m.isinf
isfinite = _m.isfinite
stanh = _m.stanh
logit = _m.logit
nan_to_num = _m.nan_to_num
multiplex = _m.multiplex
lerp = _m.lerp
diff = _m.diff
rad2deg = _m.rad2deg
deg2rad = _m.deg2rad
gcd = _m.gcd
lcm = _m.lcm
heaviside = _m.heaviside
trapezoid = _m.trapezoid
increment = _m.increment


def tanh(x, name=None):
    """tanh (op tanh, nn.functional's)."""
    from ..nn.functional import tanh as _tanh
    return _tanh(x)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """sum(x1 * x2) / max(|x1| |x2|, eps) along `axis` (op
    cosine_similarity_op, nn.functional's)."""
    from ..nn.functional import cosine_similarity as _cs
    return _cs(x1, x2, axis=axis, eps=eps)


def pow(x, y, name=None):  # noqa: A001
    """x ** y (op elementwise_pow)."""
    return _m.pow_(x, y)


def clip(x, min=None, max=None, name=None):  # noqa: A002
    """x clipped to [min, max]; tensor bounds record op clip_t (a missing
    one is float32's extreme), number bounds op clip."""
    if isinstance(min, torch.Tensor) or isinstance(max, torch.Tensor):
        lo = min if min is not None else float(np.finfo(np.float32).min)
        hi = max if max is not None else float(np.finfo(np.float32).max)
        return _m.clip_t(x, lo, hi)
    return _m.clip(x, min=float(min) if min is not None else None,
                   max=float(max) if max is not None else None)


# products
matmul = _m.matmul
dot = _m.dot
addmm = _m.addmm
outer = _m.outer
inner = _m.inner
cross = _m.cross
bmm = _m.bmm
mv = _m.mv
kron = _m.kron
mm = _m.matmul


def _positional(fn, *argnames):
    """`fn`, whose attrs are keyword-only, called with the reference's
    positional order too (`paddle.sum(x, 1)`, `x.mean(0, True)`)."""
    def wrap(x, *args, name=None, **kw):
        if len(args) > len(argnames):
            raise TypeError("%s: too many positional arguments"
                            % fn.op_type)
        for n, val in zip(argnames, args):
            if n in kw:
                raise TypeError("%s: %s given twice" % (fn.op_type, n))
            kw[n] = val
        return fn(x, **kw)
    wrap.__name__ = fn.__name__
    wrap.__doc__ = fn.__doc__
    return wrap


sum = _positional(_m.sum_, "axis", "dtype", "keepdim")  # noqa: A001
mean = _positional(_m.mean, "axis", "keepdim")
max = _positional(_m.max_, "axis", "keepdim")  # noqa: A001
min = _positional(_m.min_, "axis", "keepdim")  # noqa: A001
prod = _positional(_m.prod, "axis", "keepdim", "dtype")
any = _positional(_m.any_, "axis", "keepdim")  # noqa: A001
all = _positional(_m.all_, "axis", "keepdim")  # noqa: A001
logsumexp = _positional(_m.logsumexp, "axis", "keepdim")
amax = _positional(_m.amax, "axis", "keepdim")
amin = _positional(_m.amin, "axis", "keepdim")
nanmean = _positional(_m.nanmean, "axis", "keepdim")
nansum = _positional(_m.nansum, "axis", "keepdim")
std = _positional(_m.std, "axis", "unbiased", "keepdim")
var = _positional(_m.var, "axis", "unbiased", "keepdim")
median = _positional(_m.median, "axis", "keepdim")
nanmedian = median
cumsum = _positional(_m.cumsum, "axis")
cumprod = _positional(_m.cumprod, "dim")
logcumsumexp = _positional(_m.logcumsumexp, "axis")


def quantile(x, q, axis=None, keepdim=False):
    return _m.quantile(x, q=q, axis=axis, keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    """int64 count of the non-zero elements over `axis`."""
    nz = _m.not_equal(x, _c.zeros([1], x.dtype, device=x.device))
    return _m.sum_(_mp.cast(nz, "int64"), axis=axis, keepdim=keepdim)


# comparisons
equal = _m.equal
not_equal = _m.not_equal
greater_than = _m.greater_than
greater_equal = _m.greater_equal
less_than = _m.less_than
less_equal = _m.less_equal
logical_and = _m.logical_and
logical_or = _m.logical_or
logical_xor = _m.logical_xor
logical_not = _m.logical_not
bitwise_and = _m.bitwise_and
bitwise_or = _m.bitwise_or
bitwise_xor = _m.bitwise_xor
bitwise_not = _m.bitwise_not
isclose = _m.isclose
allclose = _m.allclose
equal_all = _m.equal_all

# search
argmax = _positional(_m.argmax, "axis", "keepdim", "dtype")
argmin = _positional(_m.argmin, "axis", "keepdim", "dtype")
argsort = _positional(_m.argsort, "axis", "descending")
sort = _positional(_m.sort, "axis", "descending")
where = _m.where
masked_select = _m.masked_select
nonzero = _m.nonzero


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    """(values, int64 indices) of the k largest (smallest) along `axis`
    (op top_k_v2)."""
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    return _m.topk(x, k=int(k), axis=int(axis), largest=largest,
                   sorted=sorted)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """(the k-th smallest value, its index) along `axis`, from a stable
    sort (ops sort_op, argsort, slice_op)."""
    vals = _m.sort(x, axis=axis)
    idx = _m.argsort(x, axis=axis)
    ax = axis % x.ndim
    v = _mp._slice(vals, axes=(ax,), starts=(k - 1,), ends=(k,))
    i = _mp._slice(idx, axes=(ax,), starts=(k - 1,), ends=(k,))
    if not keepdim:
        v = _mp.squeeze(v, axis=ax)
        i = _mp.squeeze(i, axis=ax)
    return v, i


def mode(x, axis=-1, keepdim=False, name=None):
    """Not implemented in the reference either (it raises)."""
    raise NotImplementedError("paddle_tpu.mode: planned")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted distinct values (of x flattened, or the distinct slices
    along `axis`), with the first index of each, the inverse map and the
    counts when asked (int64), as numpy's unique. Its size is read on the
    host."""
    _m.no_capture("unique")
    a = x.detach().cpu()
    a = a.float() if a.dtype == torch.bfloat16 else a
    out = np.unique(a.numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not (return_index or return_inverse or return_counts):
        return torch.from_numpy(np.ascontiguousarray(out)).to(
            x.device, x.dtype)
    res = [torch.from_numpy(np.ascontiguousarray(out[0])).to(x.device,
                                                             x.dtype)]
    for extra in out[1:]:
        res.append(torch.from_numpy(extra.astype(np.int64)).to(x.device))
    return tuple(res)


def index_select(x, index, axis=0, name=None):
    return _mp.index_select(x, index, axis=axis)


index_sample = _mp.index_sample
take_along_axis = _mp.take_along_axis
put_along_axis = _mp.put_along_axis

# ---- creation -------------------------------------------------------------
full = _c.full
zeros = _c.zeros
ones = _c.ones
full_like = _c.full_like
zeros_like = _c.zeros_like
ones_like = _c.ones_like
arange = _c.arange
linspace = _c.linspace
logspace = _c.logspace
eye = _c.eye
tril = _c.tril
triu = _c.triu
diag = _c.diag
diagflat = _c.diagflat
diag_embed = _c.diag_embed
diagonal = _c.diagonal
meshgrid = _c.meshgrid
empty = _c.empty
empty_like = _c.empty_like
clone = _c.clone
assign = _c.assign

# ---- manipulation ---------------------------------------------------------
cast = _mp.cast
reshape = _mp.reshape
transpose = _mp.transpose
t = _mp.t
flatten = _mp.flatten
squeeze = _mp.squeeze
unsqueeze = _mp.unsqueeze
concat = _mp.concat
stack = _mp.stack
unstack = _mp.unstack
split = _mp.split
chunk = _mp.chunk
slice = _mp.slice  # noqa: A001
strided_slice = _mp.strided_slice
gather = _mp.gather
gather_nd = _mp.gather_nd
scatter = _mp.scatter
scatter_nd = _mp.scatter_nd
scatter_nd_add = _mp.scatter_nd_add
tile = _mp.tile
expand = _mp.expand
expand_as = _mp.expand_as
broadcast_to = _mp.broadcast_to
broadcast_tensors = _mp.broadcast_tensors
flip = _mp.flip
roll = _mp.roll
rot90 = _mp.rot90
repeat_interleave = _mp.repeat_interleave
moveaxis = _mp.moveaxis
as_complex = _mp.as_complex
as_real = _mp.as_real
unbind = _mp.unbind
shard_index = _mp.shard_index
getitem = _mp.getitem


def numel(x, name=None):
    """The element count as an int64 0-d tensor on x's device."""
    return torch.full((), x.numel(), dtype=torch.int64, device=x.device)


def shape(x):
    """x's shape as an int32 1-D tensor on x's device."""
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_complex(x):
    return x.dtype.is_complex


def is_integer(x):
    return not (x.dtype.is_floating_point or x.dtype.is_complex
                or x.dtype == torch.bool)


def is_floating_point(x):
    return x.dtype.is_floating_point


def rank(x):
    """x's number of axes as an int32 0-d tensor."""
    return torch.full((), x.ndim, dtype=torch.int32, device=x.device)


# ---- random ---------------------------------------------------------------
randn = _r.randn
rand = _r.rand
normal = _r.normal
uniform = _r.uniform
randint = _r.randint
randint_like = _r.randint_like
randperm = _r.randperm
bernoulli = _r.bernoulli
multinomial = _r.multinomial
poisson = _r.poisson
standard_normal = _r.standard_normal

# ---- linalg ---------------------------------------------------------------
norm = _la.norm
cholesky = _la.cholesky
cholesky_solve = _la.cholesky_solve
inverse = _la.inverse
matrix_power = _la.matrix_power
det = _la.det
slogdet = _la.slogdet
svd = _la.svd
qr = _la.qr
lu = _la.lu
eig = _la.eig
eigh = _la.eigh
eigvals = _la.eigvals
eigvalsh = _la.eigvalsh
matrix_rank = _la.matrix_rank
solve = _la.solve
triangular_solve = _la.triangular_solve
lstsq = _la.lstsq
multi_dot = _la.multi_dot


def cond(x, p=None, name=None):
    return _la.cond_number(x, p=p)


histogram = _la.histogram
bincount = _la.bincount
trace = _la.trace
einsum = _la.einsum
pinv = _la.pinv
corrcoef = _la.corrcoef
cov = _la.cov


# ---- the reference's compat names ------------------------------------------


def add_n(inputs, name=None):
    """The sum of a list of tensors."""
    if isinstance(inputs, (list, tuple)):
        out = inputs[0]
        for x in inputs[1:]:
            out = _m.add(out, x)
        return out
    return inputs


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """scale * x + bias (op scale_op), then the activation `act` of
    nn.functional if given."""
    out = _m.scale_op(x, scale=float(scale), bias=float(bias),
                      bias_after_scale=bool(bias_after_scale))
    if act:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def dist(x, y, p=2, name=None):
    return _m.dist(x, y, p=float(p))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return _m.searchsorted(sorted_sequence, values, right=bool(right),
                           out_int32=bool(out_int32))


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(int(i) for i in a) if isinstance(a, (list, tuple))
                     else int(a) for a in axes)
    else:
        axes = int(axes)
    return _m.tensordot(x, y, axes=axes)


def reverse(x, axis, name=None):
    """The legacy alias of flip."""
    return flip(x, axis)


def is_empty(x, name=None):
    """A 0-d bool tensor: x has no elements."""
    return torch.full((), x.numel() == 0, dtype=torch.bool, device=x.device)


def crop(x, shape=None, offsets=None, name=None):
    """The block of `shape` at `offsets` (zeros by default); a -1 in
    shape runs to the end of that axis."""
    shp = [int(s) for s in (shape if shape is not None else x.shape)]
    offs = [int(o) for o in (offsets if offsets is not None
                             else [0] * x.ndim)]
    index = tuple(builtins.slice(o, None if s == -1 else o + s)
                  for o, s in zip(offs, shp))
    return getitem(x, index)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """x with each run of equal values (slices along `axis`) kept once,
    with the inverse map and the run lengths when asked (int64); x is
    flattened for axis None. Its size is read on the host."""
    _m.no_capture("unique_consecutive")
    out = torch.unique_consecutive(
        x.reshape(-1) if axis is None else x, return_inverse=True,
        return_counts=True, dim=None if axis is None else int(axis))
    vals, inverse, counts = out
    results = [vals]
    if return_inverse:
        results.append(inverse.reshape(-1).to(torch.int64))
    if return_counts:
        results.append(counts.to(torch.int64))
    return results[0] if len(results) == 1 else tuple(results)


def tolist(x):
    return x.tolist()


# the reference's in-place names are aliases of the pure forms (its
# tensors are functional)
reshape_ = reshape
squeeze_ = squeeze
unsqueeze_ = unsqueeze
scatter_ = scatter
tanh_ = tanh


# ---------------------------------------------------------------------------
# Tensor methods: the reference's `method_map` (paddle_tpu/tensor/
# __init__.py:478-528) names that torch.Tensor lacks

METHOD_MAP = {
    "add": add, "subtract": subtract, "multiply": multiply,
    "divide": divide, "floor_divide": floor_divide, "remainder": remainder,
    "mod": remainder, "pow": pow, "maximum": maximum, "minimum": minimum,
    "matmul": matmul, "dot": dot, "mm": matmul, "bmm": bmm,
    "abs": abs, "neg": neg, "sign": sign, "exp": exp, "log": log,
    "log2": log2, "log10": log10, "log1p": log1p, "frexp": frexp,
    "sqrt": sqrt, "rsqrt": rsqrt, "square": square,
    "reciprocal": reciprocal, "sin": sin, "cos": cos, "tan": tan,
    "tanh": tanh, "asin": asin, "acos": acos, "atan": atan, "ceil": ceil,
    "floor": floor, "round": round, "trunc": trunc, "erf": erf,
    "lgamma": lgamma, "isnan": isnan, "isinf": isinf, "isfinite": isfinite,
    "clip": clip, "sum": sum, "mean": mean, "max": max, "min": min,
    "prod": prod, "any": any, "all": all, "std": std, "var": var,
    "median": median, "logsumexp": logsumexp, "cumsum": cumsum,
    "cumprod": cumprod, "argmax": argmax, "argmin": argmin,
    "argsort": argsort, "sort": sort, "topk": topk, "nonzero": nonzero,
    "equal": equal, "not_equal": not_equal, "greater_than": greater_than,
    "greater_equal": greater_equal, "less_than": less_than,
    "less_equal": less_equal, "logical_and": logical_and,
    "logical_or": logical_or, "logical_not": logical_not,
    "logical_xor": logical_xor, "isclose": isclose, "allclose": allclose,
    "equal_all": equal_all, "reshape": reshape, "transpose": transpose,
    "flatten": flatten, "squeeze": squeeze, "unsqueeze": unsqueeze,
    "split": split, "chunk": chunk, "gather": gather,
    "gather_nd": gather_nd, "scatter": scatter, "tile": tile,
    "expand": expand, "expand_as": expand_as, "broadcast_to": broadcast_to,
    "flip": flip, "roll": roll, "unbind": unbind, "unstack": unstack,
    "index_select": index_select, "masked_select": masked_select,
    "where": where, "norm": norm, "trace": trace, "cholesky": cholesky,
    "inverse": inverse, "matrix_power": matrix_power, "det": det,
    "cross": cross, "outer": outer, "inner": inner, "kron": kron,
    "diagonal": diagonal, "tril": tril, "triu": triu, "lerp": lerp,
    "kthvalue": kthvalue, "bincount": bincount, "histogram": histogram,
    "repeat_interleave": repeat_interleave, "unique": unique, "cast": cast,
}
# the names the port's Tensor takes from the reference; the others keep
# torch's method (see the module's note)
PADDLE_METHODS = sorted(n for n in METHOD_MAP
                        if not hasattr(torch.Tensor, n)
                        and n not in Tensor.__dict__)


def _method(fn):
    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)
    method.__name__ = fn.__name__
    method.__doc__ = fn.__doc__
    return method


for _name in PADDLE_METHODS:
    setattr(Tensor, _name, _method(METHOD_MAP[_name]))
del _name

from . import manipulation, math  # noqa: E402,F401

__all__ = sorted(
    n for n, v in list(globals().items())
    if not n.startswith("_") and n not in (
        "annotations", "builtins", "np", "torch", "METHOD_MAP",
        "PADDLE_METHODS") and callable(v))
