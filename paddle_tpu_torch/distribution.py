"""paddle.distribution (counterpart of paddle_tpu/distribution.py):
Uniform, Normal, Categorical and kl_divergence.

`log_prob`, `probs`, `entropy` and `kl_divergence` are the reference's
formulas in torch ops; parameters given as Python numbers are float32, as
the reference's are. Difference by design: `sample` draws from torch's
generator on the parameters' device (the reference draws from its JAX key
chain), so the same seed gives other draws of the same distribution.
"""
from __future__ import annotations

import math

import torch

from .framework.device import resolve_device

__all__ = ["Distribution", "Uniform", "Normal", "Categorical",
           "kl_divergence"]


def _arr(x, device=None):
    """A tensor parameter as it is; anything else float32 on `device`."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float32,
                           device=resolve_device(device))


class Distribution:
    """The abstract distribution (reference: distribution.py)."""

    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        return torch.exp(self.log_prob(value))

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    """Uniform on [low, high)."""

    def __init__(self, low, high, name=None, device=None):
        self.low = _arr(low, device)
        self.high = _arr(high, self.low.device)

    def sample(self, shape=(), seed=0):
        base = torch.broadcast_shapes(self.low.shape, self.high.shape)
        u = torch.rand(tuple(shape) + tuple(base), dtype=torch.float32,
                       device=self.low.device)
        return self.low + u * (self.high - self.low)

    def entropy(self):
        return torch.log(self.high - self.low)

    def log_prob(self, value):
        v = _arr(value, self.low.device)
        inside = (v >= self.low) & (v < self.high)
        return torch.where(inside, -torch.log(self.high - self.low),
                           float("-inf"))


class Normal(Distribution):
    """Normal(loc, scale)."""

    def __init__(self, loc, scale, name=None, device=None):
        self.loc = _arr(loc, device)
        self.scale = _arr(scale, self.loc.device)

    def sample(self, shape=(), seed=0):
        base = torch.broadcast_shapes(self.loc.shape, self.scale.shape)
        z = torch.randn(tuple(shape) + tuple(base), dtype=torch.float32,
                        device=self.loc.device)
        return self.loc + z * self.scale

    def entropy(self):
        return (0.5 + 0.5 * math.log(2 * math.pi)
                + torch.log(self.scale * torch.ones_like(self.loc)))

    def log_prob(self, value):
        v = _arr(value, self.loc.device)
        var = self.scale ** 2
        return (-((v - self.loc) ** 2) / (2 * var) - torch.log(self.scale)
                - 0.5 * math.log(2 * math.pi))

    def kl_divergence(self, other):
        """KL(self || other) of two normals."""
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


class Categorical(Distribution):
    """Categorical over the last axis of `logits`."""

    def __init__(self, logits, name=None, device=None):
        self.logits = _arr(logits, device)

    def _log_pmf(self):
        return torch.log_softmax(self.logits, dim=-1)

    def sample(self, shape=()):
        p = torch.softmax(self.logits, dim=-1).reshape(
            -1, self.logits.shape[-1])
        n = int(math.prod(shape)) if len(tuple(shape)) else 1
        draws = torch.multinomial(p, n, replacement=True)   # [rows, n]
        out = draws.T.reshape(tuple(shape) + tuple(self.logits.shape[:-1]))
        return out.long()

    def entropy(self):
        lp = self._log_pmf()
        return -torch.sum(torch.exp(lp) * lp, dim=-1)

    def log_prob(self, value):
        v = _arr(value, self.logits.device).long()
        return self._log_pmf().gather(-1, v[..., None])[..., 0]

    def kl_divergence(self, other):
        lp, lq = self._log_pmf(), other._log_pmf()
        return torch.sum(torch.exp(lp) * (lp - lq), dim=-1)


def kl_divergence(p: Distribution, q: Distribution):
    return p.kl_divergence(q)
