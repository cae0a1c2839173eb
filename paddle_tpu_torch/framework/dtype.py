"""Dtype names (counterpart of paddle_tpu/framework/dtype.py).

The reference's dtype objects wrap numpy dtypes; the port's names are
torch's own dtypes (`paddle.float32 is torch.float32`), so a port tensor's
`dtype` compares equal to them. Unlike the reference's `DType`, a torch
dtype does not compare equal to its name: `t.dtype == "float32"` is False
on the port (a difference by design; `convert_dtype` takes names).

`get_default_dtype` is the float type `framework.tensor.to_tensor` gives a
Python float or a float64 numpy array, as the reference's `_to_array`
does; float32 unless `set_default_dtype` changed it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "dtype_name", "set_default_dtype",
           "get_default_dtype"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_BY_NAME = {"bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
            "int32": int32, "int64": int64, "float16": float16,
            "bfloat16": bfloat16, "float32": float32, "float64": float64,
            "complex64": complex64, "complex128": complex128,
            # the reference's aliases
            "float": float32, "double": float64, "int": int32,
            "long": int64}
_NAMES = {d: n for n, d in _BY_NAME.items() if n not in
          ("float", "double", "int", "long")}
_FLOATING = (float16, bfloat16, float32, float64)


def convert_dtype(dtype):
    """A name ("float32", the reference's "float", "double", "int",
    "long"), a numpy dtype or a torch dtype -> the torch dtype; None ->
    None. Raises ValueError on anything else."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise ValueError("unsupported dtype: %r" % (dtype,))
        return dtype
    if isinstance(dtype, str):
        if dtype in _BY_NAME:
            return _BY_NAME[dtype]
        raise ValueError("unknown dtype name: %r" % (dtype,))
    try:
        name = str(np.dtype(dtype))
    except TypeError:
        raise ValueError("unsupported dtype: %r" % (dtype,)) from None
    if name in _BY_NAME:
        return _BY_NAME[name]
    raise ValueError("unsupported dtype: %r" % (dtype,))


def dtype_name(dtype) -> str:
    """The reference's name of a dtype ("float32", "bfloat16", ...)."""
    return _NAMES[convert_dtype(dtype)]


_default_dtype = float32


def set_default_dtype(d):
    """The float type of `to_tensor`'s Python floats and float64 arrays;
    raises TypeError for a type that is not floating point."""
    global _default_dtype
    d = convert_dtype(d)
    if d not in _FLOATING:
        raise TypeError("default dtype must be floating point, got %s"
                        % dtype_name(d))
    _default_dtype = d


def get_default_dtype() -> str:
    return dtype_name(_default_dtype)
