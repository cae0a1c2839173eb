"""Random ops (counterpart of paddle_tpu/ops/random_ops.py): normal,
uniform, randint, randperm, bernoulli, multinomial, poisson, exponential.

The reference threads a JAX key; each op here draws from the port's
generator of the output's device (`framework.random.RNG.generator`), so
`paddle.seed(s)` makes every draw repeat. The draws are torch's, not
JAX's: the two packages' samples follow the same distribution and never
the same values. A factory takes `device` (the current place when None);
an op with a tensor input draws on that tensor's device.
"""
from __future__ import annotations

import torch

from ..framework.device import resolve_device
from ..framework.dispatch import primitive
from ..framework.dtype import convert_dtype, dtype_name, get_default_dtype
from ..framework.random import RNG
from .manipulation import int_tuple


def _gen(device):
    return RNG.generator(device)


def _dt(dtype):
    return dtype_name(convert_dtype(dtype))


@primitive("gaussian_random", nondiff=True)
def _randn(*, shape, mean=0.0, std=1.0, dtype="float32", device=None):
    dev = resolve_device(device)
    z = torch.randn(tuple(shape), generator=_gen(dev), device=dev,
                    dtype=convert_dtype(dtype))
    return z if (mean == 0.0 and std == 1.0) else mean + std * z


def randn(shape, dtype=None, name=None, device=None):
    return _randn(shape=int_tuple(shape), dtype=_dt(dtype or
                                                    get_default_dtype()),
                  device=device)


def standard_normal(shape, dtype=None, name=None, device=None):
    return randn(shape, dtype, device=device)


def normal(mean=0.0, std=1.0, shape=None, name=None, device=None):
    """N(mean, std): scalar mean and std over `shape`, or tensors
    broadcast together (then on their device)."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        dev = (mean if isinstance(mean, torch.Tensor) else std).device
        shp = torch.broadcast_shapes(
            tuple(getattr(mean, "shape", ())), tuple(getattr(std, "shape",
                                                             ())))
        r = _randn(shape=tuple(shp), dtype=get_default_dtype(), device=dev)
        return mean + std * r
    return _randn(shape=int_tuple(shape if shape is not None else [1]),
                  mean=float(mean), std=float(std),
                  dtype=get_default_dtype(), device=device)


@primitive("uniform_random", nondiff=True)
def _rand(*, shape, min=0.0, max=1.0, dtype="float32", seed=0,
          device=None):  # noqa: A002
    dev = resolve_device(device)
    gen = _gen(dev) if not seed else torch.Generator(device=dev) \
        .manual_seed(int(seed))
    u = torch.rand(tuple(shape), generator=gen, device=dev,
                   dtype=convert_dtype(dtype))
    return u if (min == 0.0 and max == 1.0) else min + (max - min) * u


def rand(shape, dtype=None, name=None, device=None):
    return _rand(shape=int_tuple(shape),
                 dtype=_dt(dtype or get_default_dtype()), device=device)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None,
            device=None):  # noqa: A002
    """U[min, max); a non-zero `seed` draws from its own generator (the
    same values every call), as the reference's own key."""
    return _rand(shape=int_tuple(shape), min=float(min), max=float(max),
                 dtype=_dt(dtype or get_default_dtype()), seed=int(seed),
                 device=device)


def rand_like(x, dtype=None):
    return _rand(shape=tuple(x.shape), dtype=_dt(dtype or x.dtype),
                 device=x.device)


def randn_like(x, dtype=None):
    return _randn(shape=tuple(x.shape), dtype=_dt(dtype or x.dtype),
                  device=x.device)


@primitive("randint_op", nondiff=True)
def _randint(*, low, high, shape, dtype="int64", device=None):
    dev = resolve_device(device)
    return torch.randint(int(low), int(high), tuple(shape),
                         generator=_gen(dev), device=dev,
                         dtype=convert_dtype(dtype))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None,
            device=None):
    """Integers in [low, high) ([0, low) with one bound), int64."""
    if high is None:
        low, high = 0, low
    return _randint(low=int(low), high=int(high), shape=int_tuple(shape),
                    dtype=_dt(dtype or "int64"), device=device)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return _randint(low=int(low), high=int(high), shape=tuple(x.shape),
                    dtype=_dt(dtype or x.dtype), device=x.device)


@primitive("randperm_op", nondiff=True)
def _randperm(*, n, dtype="int64", device=None):
    dev = resolve_device(device)
    return torch.randperm(int(n), generator=_gen(dev), device=dev,
                          dtype=convert_dtype(dtype))


def randperm(n, dtype="int64", name=None, device=None):
    return _randperm(n=int(n), dtype=_dt(dtype), device=device)


@primitive("bernoulli_op", out_like=0, nondiff=True)
def _bernoulli(x):
    return torch.bernoulli(x, generator=_gen(x.device))


def bernoulli(x, name=None):
    """1 with probability x, else 0, in x's type."""
    return _bernoulli(x)


@primitive("multinomial_op", nondiff=True)
def _multinomial(x, *, num_samples=1, replacement=False):
    return torch.multinomial(x, int(num_samples), replacement=replacement,
                             generator=_gen(x.device)).to(torch.int64)


def multinomial(x, num_samples=1, replacement=False, name=None):
    """int64 category draws from the (unnormalised) weights of each row."""
    return _multinomial(x, num_samples=int(num_samples),
                        replacement=bool(replacement))


@primitive("poisson_op", out_like=0, nondiff=True)
def _poisson(x):
    return torch.poisson(x, generator=_gen(x.device))


def poisson(x, name=None):
    return _poisson(x)


@primitive("exponential_op", out_like=0, nondiff=True)
def _exponential(x, *, lam=1.0):
    out = torch.empty_like(x, requires_grad=False)
    return out.exponential_(lam, generator=_gen(x.device))


def exponential_(x, lam=1.0, name=None):
    """x filled in place with Exp(lam) draws."""
    out = _exponential(x, lam=float(lam))
    with torch.no_grad():
        x.copy_(out)
    return x
