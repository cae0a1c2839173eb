"""Tensor functions of the ported paths (counterpart of paddle_tpu/tensor,
whose ResNet imports `flatten` from here), each a registered op under the
reference's name (paddle_tpu/ops/math.py, ops/manipulation.py): the ops a
static `Variable`'s methods record (static/program.py)."""
from __future__ import annotations

from ..framework.dispatch import primitive

__all__ = ["flatten", "add", "reshape", "transpose", "squeeze", "mean",
           "getitem"]


@primitive("elementwise_add")
def add(x, y):
    """x + y (op elementwise_add)."""
    return x + y


@primitive("reshape2")
def _reshape(x, shape):
    return x.reshape(tuple(shape))


@primitive("transpose2")
def _transpose(x, perm):
    return x.permute(tuple(perm))


@primitive("flatten_contiguous_range")
def _flatten(x, start_axis=0, stop_axis=-1):
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    return x.reshape(tuple(x.shape[:s]) + (-1,) + tuple(x.shape[e + 1:]))


@primitive("squeeze2")
def _squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    axes = tuple(a % x.ndim for a in (axis if isinstance(axis, (tuple, list))
                                      else (axis,))
                 if x.shape[a % x.ndim] == 1)
    return x.squeeze(axes) if axes else x


@primitive("reduce_mean")
def _mean(x, axis=None, keepdim=False):
    if axis is None:
        out = x.mean()
        return out.reshape((1,) * x.ndim) if keepdim else out
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    return x.mean(dim=axes, keepdim=keepdim)


@primitive("getitem")
def _getitem(x, index):
    return x[index]


@primitive("identity")
def _identity(x):
    """What `Program.clone(for_test=True)` turns a dropout into."""
    return x


def reshape(x, shape):
    """op reshape2."""
    return _reshape(x, shape=tuple(int(s) for s in shape))


def transpose(x, perm):
    """op transpose2: the axes in the order `perm`."""
    return _transpose(x, perm=tuple(int(p) for p in perm))


def flatten(x, start_axis=0, stop_axis=-1):
    """Axes start_axis..stop_axis merged into one (reference:
    ops/manipulation.py flatten :66, op flatten_contiguous_range); a 0-d
    input becomes [1]."""
    return _flatten(x, start_axis=int(start_axis), stop_axis=int(stop_axis))


def squeeze(x, axis=None):
    """op squeeze2: the size-1 axes among `axis` (all size-1 axes for
    None) dropped."""
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    elif axis is not None:
        axis = (int(axis),)
    return _squeeze(x, axis=axis)


def mean(x, axis=None, keepdim=False):
    """op reduce_mean: the mean over `axis` (every axis for None)."""
    if axis is None:
        return _mean(x)
    return _mean(x, axis=axis, keepdim=bool(keepdim))


def getitem(x, index):
    """op getitem: x[index] for a static index (ints, slices, None,
    Ellipsis)."""
    return _getitem(x, index=index)
