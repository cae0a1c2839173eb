"""Tensor creation ops (counterpart of paddle_tpu/ops/creation.py): full /
zeros / ones and their `_like` forms, arange, linspace, logspace, eye,
tril / triu, the diag family, meshgrid, empty, clone, assign, complex.

A factory takes `device`: the current place when None (the card unless
the caller chose the CPU; raises without CUDA), as every entry point of
the port. A `_like` op, and any op with a tensor input, makes its output
on that input's device. Default dtypes are the reference's: an int fill
value or an all-int arange gives int64, a float one the default float
type (float32).
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.device import resolve_device
from ..framework.dispatch import primitive
from ..framework.dtype import convert_dtype, dtype_name, get_default_dtype
from .manipulation import int_tuple
from .math import identity, promote


def _name(dtype):
    return dtype_name(convert_dtype(dtype))


def _value(v):
    return v.item() if isinstance(v, torch.Tensor) else v


@primitive("fill_constant", nondiff=True)
def _full(*, shape, fill_value, dtype, device=None):
    return torch.full(tuple(shape), fill_value, dtype=convert_dtype(dtype),
                      device=resolve_device(device))


def full(shape, fill_value, dtype=None, name=None, device=None):
    """A tensor of `shape` filled with `fill_value`: int64 for an int
    value, bool for a bool, else the default float type, unless `dtype`
    is given."""
    fill_value = _value(fill_value)
    if dtype is None:
        dtype = ("bool" if isinstance(fill_value, (bool, np.bool_)) else
                 "int64" if isinstance(fill_value, (int, np.integer)) else
                 get_default_dtype())
    if not isinstance(fill_value, (bool, np.bool_)):
        fill_value = float(fill_value)
    return _full(shape=int_tuple(shape), fill_value=fill_value,
                 dtype=_name(dtype), device=device)


def zeros(shape, dtype=None, name=None, device=None):
    return full(shape, 0.0 if dtype is None else 0,
                dtype or get_default_dtype(), device=device)


def ones(shape, dtype=None, name=None, device=None):
    return full(shape, 1.0 if dtype is None else 1,
                dtype or get_default_dtype(), device=device)


@primitive("fill_like", nondiff=True)
def _full_like(x, *, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=convert_dtype(dtype),
                           requires_grad=False)


def full_like(x, fill_value, dtype=None, name=None):
    """x's shape (and dtype unless given) filled with `fill_value`, on x's
    device."""
    return _full_like(x, fill_value=_value(fill_value),
                      dtype=_name(dtype) if dtype is not None else None)


def zeros_like(x, dtype=None, name=None):
    return full_like(x, 0, dtype)


def ones_like(x, dtype=None, name=None):
    return full_like(x, 1, dtype)


@primitive("arange", nondiff=True)
def _arange(*, start, end, step, dtype, device=None):
    dt = convert_dtype(dtype)
    dev = resolve_device(device)
    if dt.is_floating_point:
        # jnp.arange of floats: start + i * step in float64, the count
        # ceil((end - start) / step), then rounded to the type
        n = max(int(np.ceil((end - start) / step)), 0)
        return (start + torch.arange(n, dtype=torch.float64, device=dev)
                * step).to(dt)
    return torch.arange(start, end, step, dtype=dt, device=dev)


def arange(start=0, end=None, step=1, dtype=None, name=None, device=None):
    """[start, end) by step; int64 when all three are ints, else the
    default float type, unless `dtype` is given."""
    if end is None:
        start, end = 0, start
    start, end, step = _value(start), _value(end), _value(step)
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
                 else get_default_dtype())
    return _arange(start=start, end=end, step=step, dtype=_name(dtype),
                   device=device)


@primitive("linspace", nondiff=True)
def _linspace(*, start, stop, num, dtype, device=None):
    dt = convert_dtype(dtype)
    out = torch.linspace(start, stop, num, dtype=torch.float64,
                         device=resolve_device(device))
    return out.to(dt)


def linspace(start, stop, num, dtype=None, name=None, device=None):
    return _linspace(start=_value(start), stop=_value(stop),
                     num=int(_value(num)),
                     dtype=_name(dtype or get_default_dtype()),
                     device=device)


@primitive("logspace", nondiff=True)
def _logspace(*, start, stop, num, base, dtype, device=None):
    dt = convert_dtype(dtype)
    out = torch.logspace(start, stop, num, base=base, dtype=torch.float64,
                         device=resolve_device(device))
    return out.to(dt)


def logspace(start, stop, num, base=10.0, dtype=None, name=None,
             device=None):
    return _logspace(start=_value(start), stop=_value(stop),
                     num=int(_value(num)), base=_value(base),
                     dtype=_name(dtype or get_default_dtype()),
                     device=device)


@primitive("eye_op", nondiff=True)
def _eye(*, num_rows, num_columns, dtype, device=None):
    return torch.eye(num_rows, num_columns, dtype=convert_dtype(dtype),
                     device=resolve_device(device))


def eye(num_rows, num_columns=None, dtype=None, name=None, device=None):
    return _eye(num_rows=int(num_rows),
                num_columns=int(num_columns if num_columns is not None
                                else num_rows),
                dtype=_name(dtype or get_default_dtype()), device=device)


@primitive("tril_op")
def tril(x, *, diagonal=0):
    return torch.tril(x, diagonal=int(diagonal))


@primitive("triu_op")
def triu(x, *, diagonal=0):
    return torch.triu(x, diagonal=int(diagonal))


@primitive("diag_v2")
def diag(x, *, offset=0, padding_value=0):
    """A 1-D x: the matrix with x on diagonal `offset` (the rest
    `padding_value`); a 2-D x: its diagonal `offset`."""
    if x.ndim == 1:
        d = torch.diag(x, offset)
        if padding_value != 0:
            mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
            d = torch.where(mask, d, torch.full_like(d, padding_value))
        return d
    return torch.diagonal(x, offset=offset).clone()


@primitive("diagflat")
def diagflat(x, *, offset=0):
    return torch.diagflat(x, offset)


@primitive("diag_embed")
def diag_embed(x, *, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset=offset, dim1=dim1, dim2=dim2)


@primitive("diagonal")
def diagonal(x, *, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2).clone()


@primitive("meshgrid_op", nondiff=True)
def _meshgrid(*xs):
    return tuple(t.clone() for t in torch.meshgrid(*xs, indexing="ij"))


def meshgrid(*args, **kwargs):
    """The "ij" grids of 1-D tensors, given as arguments or one list."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(_meshgrid(*args))


def empty(shape, dtype=None, name=None, device=None):
    """zeros, as the reference's (it has no uninitialised memory)."""
    return zeros(shape, dtype, device=device)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def clone(x, name=None):
    """A copy of x that stays in the autograd graph (op identity, then a
    copy)."""
    return identity(x).clone()


def assign(x, output=None):
    """A copy of x (a tensor, numpy array or Python data; data goes to the
    current place); with `output`, written into it in place."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        x = torch.from_numpy(a).to(resolve_device(None))
    out = identity(x).clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


@primitive("complex_op")
def complex_(real, imag):
    real, imag = promote(real, imag)
    if not real.is_floating_point():
        real, imag = real.double(), imag.double()
    return torch.complex(real, imag)
