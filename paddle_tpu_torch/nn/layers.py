"""Layers of the serving path as torch.nn.Modules (counterparts of
paddle_tpu/nn/layers.py Linear, Embedding, LayerNorm and Dropout).

Parameters are created on the CPU and drawn from the explicit
`torch.Generator` the caller passes; the model factory moves the finished
module to its device. A `Linear` weight is [in, out], as in paddle.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import functional as F

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout"]


def _normal(shape, std, generator):
    return torch.empty(shape).normal_(0.0, std, generator=generator)


class Linear(nn.Module):
    """y = x @ weight + bias, weight [in, out] with paddle's XavierNormal
    init, bias zeros."""

    def __init__(self, in_features, out_features, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        std = math.sqrt(2.0 / (in_features + out_features))
        self.weight = nn.Parameter(
            _normal((in_features, out_features), std, generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Row lookup in weight [num_embeddings, embedding_dim], N(0, std)."""

    def __init__(self, num_embeddings, embedding_dim, std=1.0,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            _normal((num_embeddings, embedding_dim), std, generator))

    def forward(self, ids):
        return self.weight[ids.long()]


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, weight ones and bias zeros."""

    def __init__(self, normalized_shape, epsilon=1e-5):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(normalized_shape))
        self.bias = nn.Parameter(torch.zeros(normalized_shape))

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self._epsilon)


class Dropout(nn.Module):
    """The identity in eval (see functional.dropout)."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, self.training)
