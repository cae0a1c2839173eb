"""paddle.fft (counterpart of paddle_tpu/fft.py) on `torch.fft` (cuFFT on
the card).

Each transform is registered under the reference's op type ("fft",
"rfft2", ...) with its attrs (n / s, axis / axes, norm), so a static
program records it. Dtypes are the reference's under x64: a real input
computes in its inexact type (`ops/math.py` `inexact_dtype`: float32 and
narrower integers in float32, float64 and int64 in float64), so a
float32 input gives complex64 and a float64 input complex128; the inverse
real transforms give the matching real type.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework.device import resolve_device
from .framework.dispatch import primitive
from .framework.dtype import convert_dtype
from .ops.math import inexact_dtype

__all__ = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
           "fft2", "ifft2", "rfft2", "irfft2",
           "fftn", "ifftn", "rfftn", "irfftn",
           "fftfreq", "rfftfreq", "fftshift", "ifftshift"]


def _inexact(x):
    dt = inexact_dtype(x.dtype)
    return x if x.dtype == dt else x.to(dt)


def _complex(x):
    """x as the complex type of its inexact type (the input of a complex
    transform of a real tensor)."""
    x = _inexact(x)
    if x.is_complex():
        return x
    return x.to(torch.complex128 if x.dtype == torch.float64
                else torch.complex64)


def _mk1d(tfn, opname, real_in=False):
    @primitive(opname)
    def op(x, n=None, axis=-1, norm="backward"):
        x = _inexact(x) if real_in else _complex(x)
        return tfn(x, n=n, dim=axis, norm=norm).resolve_conj()

    def api(x, n=None, axis=-1, norm="backward", name=None):
        return op(x, n=n, axis=axis, norm=norm)
    api.__name__ = opname
    api.__doc__ = "paddle.fft.%s (op %s): torch.fft.%s." % (
        opname, opname, opname)
    return api


def _mknd(tfn, opname, default_axes=None, real_in=False):
    @primitive(opname)
    def op(x, s=None, axes=default_axes, norm="backward"):
        x = _inexact(x) if real_in else _complex(x)
        return tfn(x, s=s, dim=axes, norm=norm)

    def api(x, s=None, axes=default_axes, norm="backward", name=None):
        if axes is not None:
            axes = tuple(axes)
        return op(x, s=None if s is None else tuple(s), axes=axes, norm=norm)
    api.__name__ = opname
    api.__doc__ = "paddle.fft.%s (op %s): torch.fft.%s." % (
        opname, opname, opname)
    return api


fft = _mk1d(torch.fft.fft, "fft")
ifft = _mk1d(torch.fft.ifft, "ifft")
rfft = _mk1d(torch.fft.rfft, "rfft", real_in=True)
irfft = _mk1d(torch.fft.irfft, "irfft")
hfft = _mk1d(torch.fft.hfft, "hfft")
ihfft = _mk1d(torch.fft.ihfft, "ihfft", real_in=True)

fft2 = _mknd(torch.fft.fftn, "fft2", (-2, -1))
ifft2 = _mknd(torch.fft.ifftn, "ifft2", (-2, -1))
rfft2 = _mknd(torch.fft.rfftn, "rfft2", (-2, -1), real_in=True)
irfft2 = _mknd(torch.fft.irfftn, "irfft2", (-2, -1))
fftn = _mknd(torch.fft.fftn, "fftn")
ifftn = _mknd(torch.fft.ifftn, "ifftn")
rfftn = _mknd(torch.fft.rfftn, "rfftn", real_in=True)
irfftn = _mknd(torch.fft.irfftn, "irfftn")


def fftfreq(n, d=1.0, dtype=None, name=None, device=None):
    """The sample frequencies of an n-point transform, in `dtype`
    (float32 by default), computed in float64 as numpy does."""
    return torch.from_numpy(np.fft.fftfreq(n, d)).to(
        device=resolve_device(device),
        dtype=convert_dtype(dtype or "float32"))


def rfftfreq(n, d=1.0, dtype=None, name=None, device=None):
    return torch.from_numpy(np.fft.rfftfreq(n, d)).to(
        device=resolve_device(device),
        dtype=convert_dtype(dtype or "float32"))


@primitive("fftshift")
def _fftshift(x, axes=None):
    return torch.fft.fftshift(x, dim=axes)


@primitive("ifftshift")
def _ifftshift(x, axes=None):
    return torch.fft.ifftshift(x, dim=axes)


def _axes(axes):
    if axes is None:
        return None
    return tuple(axes) if isinstance(axes, (list, tuple)) else (axes,)


def fftshift(x, axes=None, name=None):
    return _fftshift(x, axes=_axes(axes))


def ifftshift(x, axes=None, name=None):
    return _ifftshift(x, axes=_axes(axes))
